"""Work functions of the kernel entries, one file each."""
