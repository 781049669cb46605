"""Version of starch3-tpu.

The reference identifies itself as version 0.1 (reference src/starch3.cpp:4,
get_client_starch_version "0.1" in include/starch3api.hpp via print_version);
this rebuild starts its own line.
"""

__version__ = "1.1.0"

# Archive-format version written into metadata (see format/SPEC.md).
FORMAT_VERSION = (1, 1, 0)
