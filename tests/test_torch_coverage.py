"""The port is whole: every public name of the JAX package has a counterpart.

Read with `ast` only; nothing is imported. For every module of `rgbdseg_tpu/`
and every JAX root script, each public top-level function and class, and each
public method of a top-level class, must be
- defined in the port's module at the same path (`rgbdseg_tpu/x/y.py` ->
  `rgbdseg_torch/x/y.py`; the root scripts of `PORT_SCRIPTS`): a def, a class,
  a method, or a module-level assignment;
- or listed in `RENAMED` with the port's `module::name`, which must exist;
- or listed in `CLOSED` with its one-line reason, which ROADMAP.md §1 states
  word for word ("Closed without a module").
`PENDING`, the modules still to port, is empty: the bench entry (`bench.py` ->
`bench_torch.py`) was the last. A JAX name added without a counterpart fails
here. Every function that
encloses a `pl.pallas_call` must stand in PERF.md §6's kernel table, with its
call's line, in a row whose port column is filled.
"""

import ast
import re
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_SCRIPTS = sorted(["finetune.py", "predict.py", "bench.py", "__graft_entry__.py", "_roofline.py",
                      "_bisect_train.py"] + [p.name for p in REPO.glob("_prof_*.py")]
                     + [p.name for p in REPO.glob("_hlo_*.py")])
JAX_MODULES = sorted(str(p.relative_to(REPO)) for p in (REPO / "rgbdseg_tpu").rglob("*.py")) + JAX_SCRIPTS
PORT_SCRIPTS = {"finetune.py": "finetune_torch.py", "predict.py": "predict_torch.py", "bench.py": "bench_torch.py"}

# JAX module::name -> the port's module::name that does its work under another name
RENAMED = {
    "rgbdseg_tpu/models/common.py::ConvParams": "rgbdseg_torch/models/layers.py::Conv2d",
    "rgbdseg_tpu/models/fusion.py::TorchBatchNorm": "rgbdseg_torch/models/layers.py::BatchNorm2d",
    "rgbdseg_tpu/models/swin.py::drop_path": "rgbdseg_torch/models/stochastic.py::drop_path",
    "rgbdseg_tpu/native/__init__.py::_RleNative.encode": "rgbdseg_torch/native/__init__.py::RleCodec.encode",
    "rgbdseg_tpu/native/__init__.py::_RleNative.decode": "rgbdseg_torch/native/__init__.py::RleCodec.decode",
    "rgbdseg_tpu/ops/kernels/deformable.py::tent_sample_level":
        "rgbdseg_torch/ops/kernels/deformable.py::deform_sample_level",
    "rgbdseg_tpu/ops/kernels/deformable.py::tent_sample_level_band":
        "rgbdseg_torch/ops/kernels/deformable.py::deform_sample_level",
    "rgbdseg_tpu/ops/kernels/deformable.py::tent_sample_level_xla":
        "rgbdseg_torch/ops/kernels/deformable.py::deform_sample_level_plain",
    "rgbdseg_tpu/ops/kernels/deformable.py::tent_sample_level_xla_separable":
        "rgbdseg_torch/ops/kernels/deformable.py::deform_sample_level_plain",
    "rgbdseg_tpu/ops/kernels/masked_attention.py::masked_cross_attention_xla":
        "rgbdseg_torch/ops/kernels/masked_attention.py::masked_cross_attention_plain",
    # the cost; `mask2former_loss` assigns every layer at once with `matcher.hungarian_batch`
    "rgbdseg_tpu/ops/losses.py::match": "rgbdseg_torch/ops/losses.py::match_cost",
    "rgbdseg_tpu/ops/matcher.py::hungarian": "rgbdseg_torch/ops/matcher.py::hungarian_batch",
    "rgbdseg_tpu/parallel/sharding.py::shard_params": "rgbdseg_torch/parallel/sharding.py::shard_model",
    "__graft_entry__.py::entry": "chip_smoke.py::run_slice",
    "__graft_entry__.py::dryrun_multichip": "chip_smoke.py::run_parallel",
}

NO_CALLER = "dead code: no caller in the JAX package"
SHARDING = ("a JAX sharding idiom: the port runs one process per device, each rank loads its rows "
            "(`host_row_range`), and DDP and `shard_model` place the rest")
PROFILING = ("an XLA profiling script (HLO, the TPU profiler); on the card `chip_smoke.py --profile`, "
             "`kernel_ab.py` and the Trainer's `torch.profiler` window do its work")
# JAX module (all of it) or module::name -> why the port has no counterpart (ROADMAP.md §1)
CLOSED = {
    "rgbdseg_tpu/ops/conv.py": ("the im2col formulation of the small-channel convolutions for the TPU's MXU; "
                                "`models/layers.py::Conv2d` (cuDNN on the card) computes the same function"),
    "rgbdseg_tpu/ops/image.py::minmax_normalize": NO_CALLER,
    "rgbdseg_tpu/native/__init__.py::_RleNative.counts_from_mask": NO_CALLER,
    "rgbdseg_tpu/native/__init__.py::_RleNative.iou_counts": NO_CALLER,
    "rgbdseg_tpu/ops/resize.py::grid_sample_bilinear": ("the JAX twin of torch's `F.grid_sample`, which the "
                                                        "port's criterion calls; K1 replaces it in the decoder"),
    "rgbdseg_tpu/ops/kernels/__init__.py::use_pallas": ("chooses between the Pallas kernels and their XLA twins "
                                                        "on the TPU; the port's wrappers choose by the tensor's "
                                                        "device: the CUDA kernel on the card, the plain version "
                                                        "on the CPU"),
    "rgbdseg_tpu/parallel/mesh.py::data_sharding": SHARDING,
    "rgbdseg_tpu/parallel/mesh.py::replicated": SHARDING,
    "rgbdseg_tpu/parallel/multihost.py::global_batch_array": SHARDING,
    "rgbdseg_tpu/train/checkpoints.py::migrate_checkpoint": ("rewrites orbax checkpoints of the BatchNorm layout "
                                                             "before the JAX package's round-2 merge; the port "
                                                             "neither reads orbax nor ever wrote that layout"),
    **{name: PROFILING for name in JAX_SCRIPTS if name.startswith(("_prof_", "_hlo_", "_roofline", "_bisect"))},
}

PENDING = {}  # JAX module or module::name -> why it waits; nothing waits


def _public_names(path: Path) -> list[str]:
    """Public top-level functions and classes, and the public methods of every top-level class."""
    out = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if not node.name.startswith("_"):
                out.append(node.name)
            if isinstance(node, ast.ClassDef):
                out += [f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) and not m.name.startswith("_")]
    return out


def _top_level(body):
    """Module-level statements, those under an `if` or a `try` included."""
    for node in body:
        if isinstance(node, (ast.If, ast.Try)):
            yield from _top_level(node.body + node.orelse + getattr(node, "finalbody", [])
                                  + [s for h in getattr(node, "handlers", []) for s in h.body])
        else:
            yield node


def _defined(path: Path) -> set[str]:
    """Everything a module defines at its top level: defs, classes, their methods and fields, assignments."""
    out = set()
    if not path.exists():
        return out
    for node in _top_level(ast.parse(path.read_text()).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                for m in node.body:
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        out.add(f"{node.name}.{m.name}")
                    elif isinstance(m, ast.AnnAssign) and isinstance(m.target, ast.Name):
                        out.add(f"{node.name}.{m.target.id}")
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return out


def _port_module(jax_module: str) -> str | None:
    if jax_module.startswith("rgbdseg_tpu/"):
        return "rgbdseg_torch/" + jax_module[len("rgbdseg_tpu/"):]
    return PORT_SCRIPTS.get(jax_module)


def _exists(target: str) -> bool:
    module, name = target.split("::")
    return name in _defined(REPO / module)


def _roadmap_section_1() -> str:
    text = (REPO / "ROADMAP.md").read_text()
    return " ".join(text[text.index("### 1."):text.index("### 2.")].split())


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_a_counterpart(module):
    port = _port_module(module)
    ours = _defined(REPO / port) if port else set()
    missing = []
    for name in _public_names(REPO / module):
        key = f"{module}::{name}"
        if name in ours or module in CLOSED or module in PENDING or key in CLOSED or key in PENDING:
            continue
        if key in RENAMED:
            assert _exists(RENAMED[key]), f"{key} -> {RENAMED[key]}, which the port does not define"
            continue
        missing.append(name)
    assert not missing, f"{module}: no counterpart in {port or 'the port'} and no RENAMED or CLOSED entry: {missing}"


def test_tables_name_jax_names_without_a_counterpart_at_their_path():
    """No stale entry: each names a JAX module or public name that exists, and the port has no name of its own
    at the same path for it."""
    for key in {**RENAMED, **CLOSED, **PENDING}:
        module, _, name = key.partition("::")
        assert module in JAX_MODULES, key
        if name:
            assert name in _public_names(REPO / module), key
            port = _port_module(module)
            assert not (port and name in _defined(REPO / port)), f"{key} is defined at its own path"


def test_closed_entries_carry_the_roadmap_reason():
    section = _roadmap_section_1()
    for key, reason in CLOSED.items():
        assert reason and "\n" not in reason, key
        assert " ".join(reason.split()) in section, f"ROADMAP.md §1 does not state the reason for {key}: {reason}"


def test_only_the_bench_entry_is_pending():
    """The bench entry was the last module pending; now none is, and ROADMAP.md
    §1 says the port does all the JAX package does."""
    assert PENDING == {}
    assert _port_module("bench.py") == "bench_torch.py" and (REPO / "bench_torch.py").exists()
    section = _roadmap_section_1()
    assert "bench entry" in section and "all that the JAX package does" in section


def _pallas_functions() -> list[tuple[str, str, int]]:
    """(module, the innermost function enclosing a `pl.pallas_call`, the call's line) of every call site."""
    out = []
    for module in JAX_MODULES:
        tree = ast.parse((REPO / module).read_text())

        def visit(node, fn):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.Call) and isinstance(child.func, ast.Attribute) \
                        and child.func.attr == "pallas_call" and isinstance(child.func.value, ast.Name) \
                        and child.func.value.id == "pl":
                    out.append((module, fn, child.lineno))
                visit(child, child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn)

        visit(tree, None)
    return out


def _kernel_rows() -> list[list[str]]:
    text = (REPO / "PERF.md").read_text()
    findings = text[text.index("## 6. Findings"):text.index("## 7.")]
    return [[c.strip() for c in line.strip().strip("|").split("|")] for line in findings.splitlines()
            if re.match(r"\|\s*K\d", line)]


def test_the_jax_package_has_its_three_pallas_call_sites():
    assert [(m, fn) for m, fn, _ in _pallas_functions()] == [
        ("rgbdseg_tpu/ops/kernels/deformable.py", "_tent_sample_level_pallas"),
        ("rgbdseg_tpu/ops/kernels/deformable.py", "_tent_sample_level_band"),
        ("rgbdseg_tpu/ops/kernels/masked_attention.py", "_mca_pallas"),
    ]


@pytest.mark.parametrize("module,fn,line", _pallas_functions())
def test_every_pallas_kernel_is_ported_in_the_perf_table(module, fn, line):
    rows = [r for r in _kernel_rows() if f"`{module}" in r[1] or f"`{module.split('/')[-1]}" in r[1]]
    rows = [r for r in rows if f"`{fn}`" in r[1] and f"`pallas_call` :{line}" in r[1]]
    assert rows, f"PERF.md §6 has no kernel row naming `{fn}` and `pallas_call` :{line} of {module}"
    for r in rows:
        assert r[2] and r[2] not in ("—", "-") and "to be ported" not in r[2], r
