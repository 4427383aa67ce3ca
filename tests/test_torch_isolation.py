"""Isolation and device rules of the PyTorch port.

- No file of ``src/repro_torch`` (nor ``chip_smoke.py``) imports ``jax`` or
  the JAX package ``repro``: an AST scan of every import statement.
- Importing the serving entry point in a fresh interpreter leaves ``jax``
  out of ``sys.modules``.
- Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
  without a GPU they raise instead of carrying on on the CPU.
- Kernel wrappers (all four: ``binned_pull``, ``msbfs_extend``, ``spmm``,
  ``mha``) take their plain PyTorch version for CPU tensors without
  touching the launch counters, and the launchers refuse CPU tensors.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import policy_ntks, run_recursive_query
from repro_torch.graph.generators import erdos_renyi
from repro_torch.kernels.binned_pull.binned_pull import fused_binned_pull
from repro_torch.kernels.binned_pull.ops import binned_pull
from repro_torch.kernels.block_spmm.block_spmm import block_spmm
from repro_torch.kernels.block_spmm.ops import spmm, spmm_blocks_from_csr
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention,
)
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.kernels.msbfs_extend.msbfs_extend import msbfs_extend_blocks
from repro_torch.kernels.msbfs_extend.ops import (
    kernel_blocks_from_csr,
    msbfs_extend,
)
from repro_torch.core import build_operands
from repro_torch.launch import serve
from repro_torch.runtime.scheduler import AdaptiveScheduler

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    smoke = ROOT / "chip_smoke.py"
    return files + ([smoke] if smoke.exists() else [])


def absolute_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_never_imports_jax_or_the_jax_package():
    files = port_files()
    assert len(files) > 20
    bad = [
        f"{p.relative_to(ROOT)}: {mod}"
        for p in files for mod in absolute_imports(p)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_serve_import_leaves_jax_unloaded():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, repro_torch.launch.serve, repro_torch.core, "
            "repro_torch.runtime.scheduler; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "raise SystemExit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda_unless_cpu(no_cuda):
    csr = erdos_renyi(64, 3.0, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AdaptiveScheduler(None, csr)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.QueryService(None, csr)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_recursive_query(None, csr, [0], policy_ntks())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--closed-loop", "--scale", "0.05", "--batches", "1"])
    assert resolve_device("cpu") == torch.device("cpu")
    sched = AdaptiveScheduler("cpu", csr, phase1_iters=2)
    out = sched.query(np.array([0, 5], np.int32))
    assert out.result.state.levels.device.type == "cpu"


def test_wrappers_take_plain_path_for_cpu_tensors():
    csr = erdos_renyi(200, 4.0, seed=1)
    ops, n_pad = build_operands(csr, "pull_binned_fused")
    counters = (fused_binned_pull, msbfs_extend_blocks, block_spmm,
                flash_attention)
    launches = [f.launches for f in counters]
    g = torch.zeros(n_pad, dtype=torch.uint8)
    g[:10] = 1
    out = binned_pull(ops.rev_binned_pack, g, op="reach")
    assert out.device.type == "cpu" and out.shape == (n_pad,)
    kb = kernel_blocks_from_csr(csr)
    lanes = torch.zeros((256, 64), dtype=torch.uint8)
    lanes[3, 0] = 1
    assert msbfs_extend(kb, lanes).shape == (256, 64)
    sb = spmm_blocks_from_csr(csr, device="cpu")
    x = torch.ones((256, 64))
    assert spmm(sb, x).device.type == "cpu"
    q = torch.zeros((1, 2, 128, 32))
    assert mha(q, q, q).shape == q.shape
    assert [f.launches for f in counters] == launches
    # the launchers themselves take CUDA tensors only
    pack = ops.rev_binned_pack
    from repro_torch.kernels.binned_pull.ops import pack_plan

    with pytest.raises(ValueError, match="CUDA"):
        fused_binned_pull("reach", pack_plan(pack),
                          [s[0] for s in pack.slabs], None, g,
                          pack.perm_pad[0], pack.rows_local, None)
    with pytest.raises(ValueError, match="CUDA"):
        msbfs_extend_blocks(kb.blocks, kb.block_rows, kb.block_cols,
                            lanes.reshape(2, 128, 64))
    with pytest.raises(ValueError, match="CUDA"):
        block_spmm(sb.blocks, sb.block_rows, sb.col_ptr,
                   x.reshape(2, 128, 64))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)
    assert [f.launches for f in counters] == launches


def test_single_device_merges_are_identity_and_axes_raise():
    from repro_torch.core.collectives import merge_contribution

    x = torch.tensor([1, 0, 1], dtype=torch.uint8)
    c = torch.tensor([4, 2, 7], dtype=torch.int32)
    assert merge_contribution("or", x) is x
    assert merge_contribution("min", c) is c
    r, p = merge_contribution("or_min", (x, c))
    assert r is x and p is c
    with pytest.raises(ValueError, match="unknown merge"):
        merge_contribution("xor", x)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        merge_contribution("or", x, ("model",))
