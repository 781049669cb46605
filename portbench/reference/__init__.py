"""The plain reference that decides ``correct``: a Starch archive worked
out again from the BED bytes alone, with NumPy, Python and the
standard library's ``bz2`` (libbz2).  It imports nothing of the program,
of JAX or of the JAX package."""
