"""Command-line interface of the port: the options of ``starch3-tpu``,
with the device path on a torch device.

    python -m starch3_tpu_torch.cli [--platform=cuda|cpu] [--jax] [options] [input]

``--jax`` keeps its name, so scripts run unchanged, and selects the
device path.  ``--platform`` names its torch device: ``cuda`` (the
default) or ``cpu`` (the plain PyTorch versions).  A ``--jax`` encode
without a card and without ``--platform=cpu`` exits non-zero; it never
falls back to the CPU.  Decode, ``--list`` and ``--chrom`` run on the
host.  The option parser and the host paths are the port's own copies of
``starch3_tpu/cli.py``'s.

Multi-host encode (``--num-hosts=N --host-id=I``): every process runs the
same command with its own ``--host-id`` and encodes its round-robin share
of the chromosomes; the streams meet over a gloo process group at
``--coordinator=HOST:PORT``, or through ``--manifest-dir=DIR``, a shared
directory; host 0 writes the archive and the others write nothing.  On a
host with several cards, give each process its card with
``CUDA_VISIBLE_DEVICES``.
"""

from __future__ import annotations

import os
import stat
import sys

from starch3_tpu_torch._version import __version__
from starch3_tpu_torch.config import CompressionMethod, EncodeConfig
from starch3_tpu_torch.errors import InputUnavailableError, OptionError, StarchError

PROG = "starch3-tpu-torch"
PLATFORMS = ("cuda", "cpu")

USAGE = f"""\
{PROG}
  version: {__version__}

  Usage:

  $ {PROG} [--platform=cuda|cpu] [--jax] [--note="foo bar baz"] [--bzip2 | --gzip] [input] > output

  The options of starch3-tpu, with the device path on a torch device:

  --jax                   Run the device path (BWT and MTF on the device)
  --device-huffman        With --jax: Huffman costing and bit packing on
                          the device too (mode fast_huff; same bytes)
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
  --num-hosts=N           Multi-host encode over N processes (one per host)
  --host-id=I             This process's host index, 0..N-1 (host 0 writes)
  --coordinator=HOST:PORT gloo rendezvous of the processes (host 0 listens)
  --manifest-dir=DIR      Shared directory as the transport instead (and
                          resume after a crash)
  --help | -h             Show this usage message
  --version | -v          Show binary version
"""


def _parse_args(argv: list[str]) -> dict:
    opts = {
        "note": "",
        "method": None,
        "decode": False,
        "list": False,
        "output": None,
        "jax": False,
        "device_huffman": False,
        "chrom": None,
        "input": None,
        "coordinator": None,
        "num_hosts": None,
        "host_id": None,
        "manifest_dir": None,
        "gzip_level": None,
        "gzip_segment": None,
        "platform": "cuda",
    }
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("--help", "-h", "-?"):
            print(USAGE)
            raise SystemExit(0)
        if a in ("--version", "-v"):
            print(f"{PROG}: {__version__}")
            raise SystemExit(0)
        if a in ("--decode", "-d"):
            opts["decode"] = True
        elif a.startswith("--chrom="):
            opts["chrom"] = a[len("--chrom=") :]
        elif a == "--chrom":
            i += 1
            if i >= len(argv):
                raise OptionError("--chrom requires a value")
            opts["chrom"] = argv[i]
        elif a == "--list":
            opts["list"] = True
        elif a == "--jax":
            opts["jax"] = True
        elif a == "--device-huffman":
            opts["device_huffman"] = True
        elif a.startswith("--platform="):
            opts["platform"] = a[len("--platform=") :]
            if opts["platform"] not in PLATFORMS:
                raise OptionError(f"--platform must be one of {PLATFORMS}")
        elif a.startswith("--gzip-level="):
            lv = _int_opt(a[len("--gzip-level=") :], "--gzip-level")
            if not 1 <= lv <= 9:
                raise OptionError("--gzip-level must be 1..9")
            opts["gzip_level"] = lv
        elif a.startswith("--gzip-segment="):
            seg = _int_opt(a[len("--gzip-segment=") :], "--gzip-segment")
            if seg < 0:
                raise OptionError("--gzip-segment must be >= 0")
            opts["gzip_segment"] = seg
        elif a.startswith("--coordinator="):
            opts["coordinator"] = a[len("--coordinator=") :]
        elif a.startswith("--num-hosts="):
            opts["num_hosts"] = _int_opt(a[len("--num-hosts=") :], "--num-hosts")
        elif a.startswith("--host-id="):
            opts["host_id"] = _int_opt(a[len("--host-id=") :], "--host-id")
        elif a.startswith("--manifest-dir="):
            opts["manifest_dir"] = a[len("--manifest-dir=") :]
        elif a in ("--bzip2", "-b"):
            _set_method(opts, CompressionMethod.BZIP2)
        elif a in ("--gzip", "-g"):
            _set_method(opts, CompressionMethod.GZIP)
        elif a.startswith("--note="):
            opts["note"] = a[len("--note=") :]
        elif a in ("--note", "-n"):
            i += 1
            if i >= len(argv):
                raise OptionError("--note requires a value")
            opts["note"] = argv[i]
        elif a.startswith("--output="):
            opts["output"] = a[len("--output=") :]
        elif a in ("--output", "-o"):
            i += 1
            if i >= len(argv):
                raise OptionError("--output requires a value")
            opts["output"] = argv[i]
        elif a.startswith("-") and a != "-":
            raise OptionError(f"unknown option {a!r}")
        else:
            if opts["input"] is not None:
                raise OptionError("multiple input files given")
            opts["input"] = a
        i += 1
    return opts


def _int_opt(value: str, name: str) -> int:
    try:
        return int(value)
    except ValueError:
        raise OptionError(f"{name} requires an integer value") from None


def _require_piped_stdin() -> None:
    """Refuse a TTY stdin, as the reference does (starch3api.hpp:890-905)."""
    mode = os.fstat(sys.stdin.fileno()).st_mode
    if not (stat.S_ISFIFO(mode) or stat.S_ISREG(mode)):
        raise InputUnavailableError(
            "no input stream available: pipe data in or name a file"
        )


def _set_method(opts: dict, m: CompressionMethod) -> None:
    if opts["method"] is not None and opts["method"] is not m:
        # the reference treats two codec flags as a fatal usage error
        # (src/starch3.cpp:159-163)
        raise OptionError("only one compression method may be selected")
    opts["method"] = m


def _read_input(path: str | None) -> bytes:
    if path is None or path == "-":
        _require_piped_stdin()
        return sys.stdin.buffer.read()
    if not os.path.exists(path):
        raise InputUnavailableError(f"input file {path!r} does not exist")
    with open(path, "rb") as f:
        return f.read()


def _stream_to_sink(output: str | None, produce) -> None:
    """Run a streaming producer into --output atomically (temp file +
    rename, so a failure never truncates an existing file) or stdout."""
    if not output:
        produce(sys.stdout.buffer)
        return
    tmp = output + ".tmp"
    try:
        with open(tmp, "wb") as f:
            produce(f)
        os.replace(tmp, output)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise

def _encode_config(opts: dict) -> EncodeConfig:
    return EncodeConfig(
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


def _check_device(opts: dict) -> None:
    """A ``--jax`` encode needs its ``--platform``'s device."""
    if opts["jax"]:
        from starch3_tpu_torch.parallel.pipeline import resolve_device

        try:
            resolve_device(opts["platform"])
        except RuntimeError as e:
            raise OptionError(str(e)) from None


def _encode_multihost(opts: dict) -> int:
    """The multi-host branch of the reference's CLI: every process runs
    this same command with its own ``--host-id``; host 0 writes the
    archive.  The process group, if any, is left before returning."""
    from starch3_tpu_torch.parallel.distributed import (
        compress_bed_bytes_multihost,
        initialize_distributed,
        shutdown_distributed,
    )

    _check_device(opts)
    initialize_distributed(opts["coordinator"], opts["num_hosts"], opts["host_id"])
    try:
        data = _read_input(opts["input"])
        archive = compress_bed_bytes_multihost(
            data,
            _encode_config(opts),
            num_hosts=opts["num_hosts"],
            host_id=opts["host_id"] or 0,
            manifest_dir=opts["manifest_dir"],
            device=opts["platform"],
        )
    finally:
        shutdown_distributed()
    if (opts["host_id"] or 0) == 0:
        if opts["output"]:
            with open(opts["output"], "wb") as f:
                f.write(archive)
        else:
            sys.stdout.buffer.write(archive)
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        opts = _parse_args(argv)
        if opts["chrom"] and not opts["decode"]:
            raise OptionError("--chrom requires --decode")
        encode = not (opts["decode"] or opts["list"])
        if encode and (opts["num_hosts"] or 0) > 1:
            return _encode_multihost(opts)
        if encode:
            platform = opts["platform"]
            config = _encode_config(opts)
            _check_device(opts)
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
        if opts["decode"] and opts["jax"]:
            # the reference's behaviour: decode runs on the host; the device
            # decode is decompress_starch_bytes(use_jax=True), whose on-card
            # figures beside the native decoder's are in PERF.md
            print(
                "starch3: note: --jax applies to encode; decode uses the "
                "native block-parallel path",
                file=sys.stderr,
            )
            opts["jax"] = False
        if (
            opts["decode"]
            and not opts["chrom"]
            and opts["input"] not in (None, "-")
        ):
            # named-file decode: windowed parallel streams written in order
            from starch3_tpu_torch.api import decompress_starch_file

            if not os.path.exists(opts["input"]):
                raise InputUnavailableError(
                    f"input file {opts['input']!r} does not exist"
                )
            _stream_to_sink(
                opts["output"], lambda f: decompress_starch_file(opts["input"], f)
            )
            return 0
        data = _read_input(opts["input"])
        if opts["list"]:
            from starch3_tpu_torch.api import list_chromosomes

            rows = list_chromosomes(data)
            cols = [
                "chromosome", "lineCount", "size", "uncompressedSize",
                "nonUniqueBaseCount", "uniqueBaseCount",
            ]
            print("\t".join(cols))
            for r in rows:
                print("\t".join(str(r[c]) for c in cols))
            return 0
        # only decode reaches here (encode and --list returned above)
        if opts["chrom"]:
            from starch3_tpu_torch.api import extract_chromosome

            out = extract_chromosome(data, opts["chrom"])
        else:
            from starch3_tpu_torch.api import decompress_starch_bytes

            out = decompress_starch_bytes(data)
        if opts["output"]:
            with open(opts["output"], "wb") as f:
                f.write(out)
        else:
            sys.stdout.buffer.write(out)
        return 0
    except StarchError as e:
        print(f"Error: {e}", file=sys.stderr)
        return e.exit_code


if __name__ == "__main__":
    raise SystemExit(main())
