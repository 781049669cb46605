"""Error types for starch3-tpu.

The reference handles every failure by printing to stderr and calling
``std::exit`` with an errno code (ENOMEM: starch3api.hpp:595-598, ENODATA:
starch3api.hpp:733,752-753,903, EINVAL: starch3api.hpp:840-848, ENOSYS:
starch3api.hpp:778-779).  The rebuild raises typed exceptions instead; the
CLI layer maps them back onto the reference's exit codes so shell behavior
matches.
"""

import errno


class StarchError(Exception):
    """Base class for all starch3-tpu errors."""

    #: errno-style exit code the CLI maps this error to.
    exit_code = 1


class InputUnavailableError(StarchError):
    """No usable input (missing file / TTY stdin).

    Mirrors the reference's ENODATA exits (starch3api.hpp:733,752-753,903).
    """

    exit_code = errno.ENODATA


class UnsupportedCodecError(StarchError):
    """Requested compression backend is not supported.

    Mirrors the reference's ENOSYS exit on --gzip (starch3api.hpp:778-779);
    note the rebuild *does* support gzip, so this only fires for unknown
    codecs.
    """

    exit_code = errno.ENOSYS


class OptionError(StarchError):
    """Invalid command-line/config combination (e.g. two codecs selected,
    reference src/starch3.cpp:159-163)."""

    exit_code = errno.EINVAL


class FormatError(StarchError):
    """Malformed .starch archive or bzip2 stream."""

    exit_code = errno.EINVAL


class BedParseError(StarchError):
    """Malformed BED input (bad field count, non-numeric coordinates,
    unsorted records where sortedness is required)."""

    exit_code = errno.EINVAL
