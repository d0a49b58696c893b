from ipx_torch.problem.lp import LP, GeneralLP, make_lp, to_standard_form
from ipx_torch.problem.generate import random_feasible_lp, random_feasible_batch
