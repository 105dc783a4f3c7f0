"""Guards of the PyTorch port: it never imports JAX or the JAX package,
CUDA-device plans go to the hand-written kernels, and a tensor that is
not on the CPU never silently gets the plain result."""
import ast
import pathlib

import pytest
import torch

from repro_torch.core import staging as tst
from repro_torch.core.types import GFactors
from repro_torch.kernels import build
from repro_torch.kernels import butterfly as bf
from repro_torch.kernels import launcher
from repro_torch.kernels.plan import (ApplyPlan, clear_plan_cache,
                                      plan_cache_stats)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    assert path.is_file()
    bad = {"jax", "jaxlib", "repro"} & set(_imported_roots(path))
    assert not bad, f"{path} imports {sorted(bad)}"


def _device_defaults(path):
    """(function, default source) of every ``device`` parameter that has a
    default in the module."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        args = node.args
        pos = args.posonlyargs + args.args
        pairs = list(zip(pos[len(pos) - len(args.defaults):], args.defaults))
        pairs += [(a, d) for a, d in zip(args.kwonlyargs, args.kw_defaults)
                  if d is not None]
        for arg, default in pairs:
            if arg.arg == "device":
                yield node.name, ast.unparse(default)


@pytest.mark.parametrize("path", [p for p in PORT_FILES
                                  if p.name != "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_entry_points_default_to_cuda(path):
    bad = [(f, d) for f, d in _device_defaults(path) if d != "'cuda'"]
    assert not bad, f"{path}: device defaults other than 'cuda': {bad}"


def test_cuda_plan_resolves_to_cuda_backend():
    plan = ApplyPlan(family="sym", mode="operator", n=16, batched=True,
                     device="cuda")
    assert plan.backend == "cuda" and plan.device == "cuda"
    assert ApplyPlan(family="sym", mode="apply", n=16,
                     device="cpu").backend == "torch"
    assert ApplyPlan(family="sym", mode="apply", n=16, device="cuda",
                     backend="torch").backend == "torch"


@pytest.mark.parametrize("kwargs,match", [
    pytest.param(dict(mode="bank", placement=object()),
                 r"placement requires batched=True \(the batch axis",
                 id="kwargs0-placement"),
    (dict(family="general", mode="bank", block_b=0), "block_b must be "
     "positive"),
    (dict(precision="bf16", block_b=-64), "block_b must be positive"),
    pytest.param(dict(placement=object()),
                 r"placement requires batched=True \(the batch axis",
                 id="kwargs3-placement"),
    (dict(block_b=0), "block_b must be positive"),
    (dict(backend="pallas"), "backend"),
])
def test_plan_rejects_unported_options(kwargs, match):
    """Bad values raise with the JAX package's messages: a non-positive
    ``block_b`` (the tile dial), a placement on an unbatched plan (the
    batch axis is what a placement splits; ``placement=`` is ported), a
    backend the port has not."""
    base = dict(family="sym", mode="apply", n=16, device="cpu")
    with pytest.raises(ValueError, match=match):
        ApplyPlan(**{**base, **kwargs})


@pytest.mark.parametrize("kwargs", [
    dict(family="general", mode="bank", block_b=64),
    dict(precision="bf16", block_b=64),
    dict(block_b=64),
])
def test_plan_accepts_block_b(kwargs):
    base = dict(family="sym", mode="apply", n=16, device="cpu")
    plan = ApplyPlan(**{**base, **kwargs})
    assert plan.block_b == 64 and plan.backend == "torch"
    assert plan._resolved_block_b() == 64


@pytest.mark.parametrize("batched,gains_shape,match", [
    (True, (1, 3, 5), "gains shape"),      # wrong width
    (True, (2, 3, 4), "gains shape"),      # wrong batch
    (True, (1, 0, 4), "at least one filter"),
    (False, (0, 4), "at least one filter"),
    (False, (1, 3, 4), "gains shape"),     # batched gains, B = 1 entry
])
def test_bank_rejects_bad_gains(batched, gains_shape, match):
    """The bank's own rejections, on the CPU path (the plain version)
    as on the kernel path (launcher._padded_gains)."""
    fwd, adj = _tables("cpu")
    x = torch.zeros((1, 3, 4) if batched else (3, 4))
    if not batched:
        fwd, adj = (tst.StagedG(*(t[0] for t in s[:5]), s.cuts, s.n)
                    for s in (fwd, adj))
    plan = ApplyPlan.for_staged(fwd, "bank")
    assert plan.batched == batched
    with pytest.raises(ValueError, match=match):
        plan.bank(fwd, adj, torch.ones(gains_shape), x)
    with pytest.raises(ValueError, match=match):
        launcher._padded_gains(torch.ones(gains_shape, device="meta"),
                               x.to("meta").reshape((-1,) + x.shape[-2:]),
                               batched, "bank")


def test_plan_cache_reuses_programs():
    clear_plan_cache()
    a = ApplyPlan(family="sym", mode="operator", n=8, device="cpu")
    b = ApplyPlan(family="sym", mode="operator", n=8, device="cpu",
                  keep="tail")          # canonicalized to the same key
    assert a.program() is b.program()
    assert plan_cache_stats() == {"hits": 1, "misses": 1, "currsize": 1}
    clear_plan_cache()
    assert plan_cache_stats()["currsize"] == 0


def _tables(device):
    f = GFactors(*(t.to(device) for t in (
        torch.tensor([[0, 2]], dtype=torch.int32),
        torch.tensor([[1, 3]], dtype=torch.int32),
        torch.ones(1, 2), torch.zeros(1, 2), torch.ones(1, 2))))
    return tst.pack_g_batch_pair(f, 4, device="cpu")


def test_non_cpu_tensor_never_gets_the_plain_result(tmp_path, monkeypatch):
    fwd, adj = _tables("cpu")
    meta = tst.StagedG(*(t.to("meta") for t in fwd[:5]), fwd.cuts, fwd.n)
    x = torch.zeros((1, 3, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        bf.batched_butterfly_apply(meta, x)
    with pytest.raises(ValueError, match="CUDA"):
        bf.batched_sym_operator_apply(meta, meta, torch.ones(
            (1, 4), device="meta"), x)
    # past the device check, the launch path builds the kernels and
    # raises when there is no toolchain: no fallback to the plain version
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "find_nvcc", _no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        launcher._chain_launch("batched_butterfly_apply", meta, x, None,
                               "head")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.library()


def _no_nvcc():
    raise RuntimeError("nvcc not found")


def test_find_nvcc_raises_without_toolchain(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if pathlib.Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this machine has a system nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_wrong_dtype_signal_raises_on_the_kernel_path():
    with pytest.raises(TypeError, match="float32"):
        launcher._check_signal(torch.zeros((1, 2, 4), dtype=torch.float64,
                                           device="meta"), 3, "t")
