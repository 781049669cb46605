"""Module for module, the port (``starch3_tpu_torch``) has a counterpart of
every public function and class of the JAX package (``starch3_tpu``), and
of every ``_jitted_*`` step builder.

Each JAX name maps to the same name in the port's module of the same path
(``ops/*_jax.py`` drops ``_jax``; ``MODULES`` lists the other paths), or
to a listed rename (``RENAMES``).  The only other way out is ``OMITTED``:
JAX mechanics, and ``replicated``, each with its reason.  The other way
round, every public name of the port is a counterpart, or is listed with
its reason in ``PORT_EXTRAS`` or ``PORT_ONLY_MODULES``.  So the test fails
when either package gains a name that the table does not account for.
The JAX package is read with ``ast``; the port is imported.
"""

import ast
import importlib
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "starch3_tpu"
PORT_PKG = ROOT / "starch3_tpu_torch"

# JAX module -> the port's module, where dropping ``_jax`` does not give it
MODULES = {
    "ops/mtf_narrow_pallas.py": "ops/mtf_narrow.py",
    "ops/mtf_pallas.py": "ops/mtf_wide.py",
    "ops/mtf_jax.py": "ops/mtf_wide.py",
}

# (JAX module, name) -> the port's name in the counterpart module, or
# "module:name" in another module of the port
RENAMES = {
    ("ops/bwt_jax.py", "bwt_encode_jax"): "bwt_encode",
    ("ops/imtf_jax.py", "imtf_decode_jax"): "imtf_decode",
    ("ops/irle2_jax.py", "irle2_decode_jax"): "irle2_decode",
    ("ops/mtf_jax.py", "mtf_ranks_padded"): "mtf_ranks_wide_reference",
    ("ops/mtf_jax.py", "mtf_ranks_jax"): "mtf_ranks_wide_host",
    ("ops/mtf_pallas.py", "mtf_ranks_pallas"): "mtf_ranks_wide",
    ("ops/mtf_pallas.py", "mtf_ranks_pallas_batch"): "mtf_ranks_wide_batch",
    ("ops/mtf_pallas.py", "mtf_ranks_pallas_host"): "mtf_ranks_wide_host",
    ("parallel/distributed.py", "gather_results_jax"): "gather_results_dist",
    ("parallel/pipeline.py", "jax_bz2_compress"): "torch_bz2_compress",
    ("parallel/pipeline.py", "_jitted_fused_step"): "step_exact",
    ("parallel/pipeline.py", "_jitted_fused_step_rle2"): "step_exact_rle2",
    ("parallel/pipeline.py", "_jitted_fused_step_ranks4"): "step_ranks4",
    ("parallel/pipeline.py", "_jitted_fused_step_ranks_mid"): "step_ranks_mid",
    ("parallel/pipeline.py", "_jitted_bwt_mtf_fast"): "step_bwt_mtf_fast",
    ("parallel/pipeline.py", "_jitted_rle2_pack"): "step_rle2_pack",
    ("parallel/pipeline.py", "_jitted_fused_step_fast"): "step_fast",
    ("parallel/pipeline.py", "_jitted_rle2_raw"): "step_rle2_raw",
    ("parallel/pipeline.py", "_jitted_fused_step_fast2"): "step_fast2",
    ("parallel/pipeline.py", "_jitted_group_hist"): "ops/huff.py:group_hist_padded",
    ("parallel/pipeline.py", "_jitted_cost_select"): "ops/huff.py:cost_and_select",
    ("parallel/pipeline.py", "_jitted_emit_coded"): "ops/bitpack.py:emit_coded_padded",
    ("parallel/pipeline.py", "_jitted_device_decode_step"): "step_decode",
}

# JAX names without a counterpart, each with its reason
OMITTED = {
    ("parallel/mesh.py", "replicated"): "no caller in either package (tests/test_torch_mesh.py)",
    ("parallel/pipeline.py", "_jitted_batch_head"): (
        "JAX mechanics: a jitted slice, so that only the occupied prefix is downloaded; "
        "a torch slice of a device tensor does that by itself"
    ),
}

# the port's modules without a JAX counterpart, each with its reason
PORT_ONLY_MODULES = {
    "_build.py": "builds the CUDA kernels and the native runtime into build/",
    "corpus.py": "the seeded corpora of chip_smoke.py and the profilers",
    "kernel_check.py": "first launches of the CUDA kernels on a sentinel-filled output",
    "profile_kernels.py": "device times of the CUDA kernels",
    "profile_lane.py": "where the device lane's time goes in a hybrid encode",
    "profile_step.py": "a tier's time breakdown on the card",
    "leg_fork.py": "the fork server that starts chip_smoke.py's scale legs without importing torch in each",
    "scale_run.py": "the legs of chip_smoke.py phases 13 to 15, every tier and mode at scale, one per process, "
                    "and BASELINE config 5's multi-host legs",
    "stall_probe.py": "which host calls wait on a stalled CUDA stream",
    "parallel/host.py": "the host scheduler and tail, copied out of the JAX package's parallel/pipeline.py",
}

# the port's public names beyond its counterparts, by module, with the reason
PORT_EXTRAS = {
    "ops/bwt.py": (("n_rounds", "doubling_round", "initial_state"),
                   "the doubling sort's rounds, which the jitted JAX sort holds in its body"),
    "ops/huff.py": (("n_groups_max",), "the selector count of a bucket, inline in the JAX ops"),
    "ops/ibwt.py": (("lf_mapping", "jump", "place"),
                    "the parts of ibwt_padded, each held to the CPU and timed apart on the card"),
    "ops/imtf.py": (("tile_permutations", "compose_exclusive", "gather_symbols"),
                    "the parts of imtf_decode_padded, each held to the CPU and timed apart on the card"),
    "ops/mtf_narrow.py": (("mtf_ranks_narrow_reference",), "the kernel's plain version"),
    "ops/mtf_wide.py": (("launch", "captured_launches", "count_launch", "count_replayed"),
                        "the windowed kernel's launch, shared with mtf_narrow at widths 32/64, and the "
                        "launch counts of both wrappers, which a CUDA graph's replay counts as its capture "
                        "recorded them"),
    "observability.py": (("Stats", "span", "span_keys"),
                         "the port's counters and spans: a counter dict with its lock, the span that times work "
                         "into it and opens a torch.profiler range only while a profiler runs (the JAX package "
                         "has StageTimer's named scopes alone), and the keys a span declares"),
    "parallel/distributed.py": (("shutdown_distributed",), "ends the gloo process group"),
    "parallel/mesh.py": (("BlockMesh", "on_entry"),
                         "a mesh of torch devices, each with its stream, in place of a jax.sharding.Mesh"),
    "parallel/pipeline.py": (
        ("resolve_device", "encode_mode", "bwt_of_batch", "bwt_remap", "raw_batch", "pack_batch",
         "step_for_class", "read_stream_blocks", "pack_decode_batch"),
        "the explicit device, the mode selection, and the pieces of the JAX dispatch and jitted steps, "
        "named so that tests and chip_smoke.py hold each to the CPU",
    ),
}


def _rel(path: Path, pkg: Path) -> str:
    return path.relative_to(pkg).as_posix()


def _defs(path: Path) -> list[str]:
    """Top-level ``def`` and ``class`` names of a source file."""
    tree = ast.parse(path.read_text())
    return [n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))]


def _counted(name: str) -> bool:
    return not name.startswith("_") or name.startswith("_jitted_")


def _port_module(jax_rel: str) -> str:
    if jax_rel in MODULES:
        return MODULES[jax_rel]
    return re.sub(r"^ops/(\w+)_jax\.py$", r"ops/\1.py", jax_rel)


def _import(port_rel: str):
    mod = "starch3_tpu_torch." + port_rel[: -len(".py")].replace("/", ".")
    return importlib.import_module(mod.removesuffix(".__init__"))


def _target(jax_rel: str, name: str) -> tuple[str, str]:
    """The port's (module, name) of a JAX module's name."""
    to = RENAMES.get((jax_rel, name), name)
    if ":" in to:
        return tuple(to.split(":"))
    return _port_module(jax_rel), to


JAX_MODULES = sorted(_rel(p, JAX_PKG) for p in JAX_PKG.rglob("*.py"))
PORT_MODULES = sorted(_rel(p, PORT_PKG) for p in PORT_PKG.rglob("*.py"))


@pytest.mark.parametrize("jax_rel", JAX_MODULES)
def test_every_jax_name_has_a_counterpart(jax_rel):
    missing = []
    for name in filter(_counted, _defs(JAX_PKG / jax_rel)):
        if (jax_rel, name) in OMITTED:
            continue
        port_rel, port_name = _target(jax_rel, name)
        if not (PORT_PKG / port_rel).exists() or not hasattr(_import(port_rel), port_name):
            missing.append(f"{name} -> {port_rel}:{port_name}")
    assert not missing, f"{jax_rel}: no counterpart in the port for {missing}"


@pytest.mark.parametrize("port_rel", PORT_MODULES)
def test_every_port_name_is_accounted_for(port_rel):
    counterparts = {}  # port name -> the JAX names it stands for
    for jax_rel in JAX_MODULES:
        for name in filter(_counted, _defs(JAX_PKG / jax_rel)):
            if (jax_rel, name) not in OMITTED:
                mod, to = _target(jax_rel, name)
                if mod == port_rel:
                    counterparts.setdefault(to, []).append(name)
    if not any(_port_module(j) == port_rel for j in JAX_MODULES):
        assert port_rel in PORT_ONLY_MODULES, f"{port_rel} has no JAX counterpart and is not listed"
        assert not counterparts, f"{port_rel} is listed as port-only but stands for {counterparts}"
        return
    assert port_rel not in PORT_ONLY_MODULES, f"{port_rel} has a JAX counterpart"
    extras = set(PORT_EXTRAS.get(port_rel, ((), ""))[0])
    unaccounted = [n for n in _defs(PORT_PKG / port_rel)
                   if not n.startswith("_") and n not in counterparts and n not in extras]
    assert not unaccounted, f"{port_rel}: public names the table does not account for: {unaccounted}"


def test_the_table_names_only_what_exists():
    """No entry of the table outlives the name it stands for."""
    for (jax_rel, name), reason in OMITTED.items():
        assert reason and name in _defs(JAX_PKG / jax_rel), (jax_rel, name)
    for jax_rel, name in RENAMES:
        assert name in _defs(JAX_PKG / jax_rel), (jax_rel, name)
    for jax_rel, port_rel in MODULES.items():
        assert (JAX_PKG / jax_rel).exists() and (PORT_PKG / port_rel).exists(), jax_rel
    for port_rel, (names, reason) in PORT_EXTRAS.items():
        assert reason and set(names) <= set(_defs(PORT_PKG / port_rel)), port_rel
    for port_rel in PORT_ONLY_MODULES:
        assert (PORT_PKG / port_rel).exists(), port_rel
    kinds = {reason.split(":")[0] for (_m, name), reason in OMITTED.items() if name != "replicated"}
    assert kinds == {"JAX mechanics"}


def _cli_options(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    parse = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "_parse_args")
    return {c.value.split("=")[0] for c in ast.walk(parse)
            if isinstance(c, ast.Constant) and isinstance(c.value, str) and re.fullmatch(r"--?[\w?][\w-]*=?", c.value)}


def test_the_clis_take_the_same_options():
    assert _cli_options(PORT_PKG / "cli.py") == _cli_options(JAX_PKG / "cli.py")
