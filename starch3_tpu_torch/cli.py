"""Command-line interface of the port: the options of ``starch3-tpu``,
with the device path on a torch device.

    python -m starch3_tpu_torch.cli [--platform=cuda|cpu] [--jax] [options] [input]

``--jax`` keeps its name, so scripts run unchanged, and selects the
device path.  ``--platform`` names its torch device: ``cuda`` (the
default) or ``cpu`` (the plain PyTorch versions).  A ``--jax`` encode
without a card and without ``--platform=cpu`` exits non-zero; it never
falls back to the CPU.  Decode, ``--list`` and ``--chrom`` are the host
paths of ``starch3_tpu.cli``.
"""

from __future__ import annotations

import os
import sys

from starch3_tpu import cli as _ref
from starch3_tpu._version import __version__
from starch3_tpu.cli import _parse_args, _require_piped_stdin, _stream_to_sink
from starch3_tpu.config import CompressionMethod, EncodeConfig
from starch3_tpu.errors import InputUnavailableError, OptionError, StarchError

PROG = "starch3-tpu-torch"
PLATFORMS = ("cuda", "cpu")

USAGE = f"""\
{PROG}
  version: {__version__}

  Usage:

  $ {PROG} [--platform=cuda|cpu] [--jax] [--note="foo bar baz"] [--bzip2 | --gzip] [input] > output

  The options of starch3-tpu, with the device path on a torch device:

  --jax                   Run the device path (BWT and MTF on the device)
  --platform=cuda|cpu     Device of the device path (default cuda; cpu
                          runs the plain PyTorch versions).  A --jax
                          encode without a card needs --platform=cpu.
  --decode | -d           decompress an archive back to BED (host)
  --decode --chrom=NAME   extract one chromosome (host)
  --list                  print the per-chromosome metadata table
  --note="foo bar baz"    Append note to archive metadata (optional)
  --bzip2 | -b            Use bzip2 backend (default)
  --gzip | -g             Use gzip backend
  --gzip-level=N          gzip compression level 1..9 (default 6)
  --gzip-segment=BYTES    bytes of transformed text per gzip member
  --output=FILE | -o      Write to FILE instead of stdout
  --help | -h             Show this usage message
  --version | -v          Show binary version

  Not ported yet: --device-huffman (ROADMAP A10), --num-hosts > 1 (A9).
"""

# options whose value is the next argument (a value is never a flag)
_VALUE_OPTS = ("--note", "-n", "--chrom", "--output", "-o")


def _split_platform(argv: list[str]) -> tuple[str, list[str]]:
    """Take ``--platform=`` out of ``argv``: (platform, other args)."""
    platform, rest = "cuda", []
    for a in argv:
        if a.startswith("--platform="):
            platform = a[len("--platform=") :]
            if platform not in PLATFORMS:
                raise OptionError(f"--platform must be one of {PLATFORMS}")
        else:
            rest.append(a)
    return platform, rest


def _first_info_flag(argv: list[str]) -> str | None:
    """The first ``--help`` or ``--version`` flag, as the JAX CLI's
    parser would meet it (skipping option values)."""
    skip = False
    for a in argv:
        if skip:
            skip = False
        elif a in _VALUE_OPTS:
            skip = True
        elif a in ("--help", "-h", "-?", "--version", "-v"):
            return a
    return None


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        platform, rest = _split_platform(argv)
        info = _first_info_flag(rest)
        if info is not None:
            print(f"{PROG}: {__version__}" if info in ("--version", "-v") else USAGE)
            return 0
        opts = _parse_args(rest)
        if opts["decode"] or opts["list"]:
            return _ref.main(rest)  # host decode, list and random access
        if opts["chrom"]:
            raise OptionError("--chrom requires --decode")
        if (opts["num_hosts"] or 0) > 1:
            raise OptionError("--num-hosts > 1: multi-host encode is not yet ported (ROADMAP A9)")
        config = EncodeConfig(
            note=opts["note"],
            method=opts["method"] or CompressionMethod.default(),
            use_jax=opts["jax"],
            device_huffman=opts["device_huffman"],
            gzip_level=opts["gzip_level"] or 6,
            **(
                {"gzip_segment_bytes": opts["gzip_segment"]}
                if opts["gzip_segment"] is not None
                else {}
            ),
        )
        if opts["jax"]:
            from starch3_tpu_torch.parallel.pipeline import check_modes, resolve_device

            try:
                check_modes(device_huffman=config.device_huffman)
                resolve_device(platform)
            except (NotImplementedError, RuntimeError) as e:
                raise OptionError(str(e)) from None
        from starch3_tpu_torch.api import compress_bed_file, compress_bed_stream

        if opts["input"] in (None, "-"):
            _require_piped_stdin()
            _stream_to_sink(
                opts["output"],
                lambda f: compress_bed_stream(sys.stdin.buffer, f, config, device=platform),
            )
            return 0
        if not os.path.exists(opts["input"]):
            raise InputUnavailableError(f"input file {opts['input']!r} does not exist")
        _stream_to_sink(
            opts["output"],
            lambda f: compress_bed_file(opts["input"], f, config, device=platform),
        )
        return 0
    except StarchError as e:
        print(f"Error: {e}", file=sys.stderr)
        return e.exit_code


if __name__ == "__main__":
    raise SystemExit(main())
