"""Isolation and device rules of the PyTorch port.

- No file of ``src/repro_torch`` (nor ``chip_smoke.py``) imports ``jax`` or
  the JAX package ``repro``: an AST scan of every import statement.
- Importing the serving entry point in a fresh interpreter leaves ``jax``
  out of ``sys.modules``.
- Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
  without a GPU they raise instead of carrying on on the CPU: the
  dispatcher, the scheduler, the open-loop ``ServingLoop`` and both
  drivers of ``serve.main`` (the open loop with ``--mutate-stream``
  included).
- Graph mutation stays on the dispatcher's device: ``apply_delta`` places
  the folded structures as new CPU tensors, never the host mirror's.
- Kernel wrappers (all four: ``binned_pull``, ``msbfs_extend``, ``spmm``,
  ``mha``) take their plain PyTorch version for CPU tensors without
  touching the launch counters, and the launchers refuse CPU tensors.
- The LM serving path (``configs/``, ``nn/``, ``models/``) is in the
  scan; ``transformer.init`` (and the cache and carry-over entry points)
  with no device raise without a GPU; on the CPU the kernel route's
  ``mha`` runs its plain version and leaves the launch counter alone.
- The GNN family (``graph/sampler.py``, ``models/gnn/``, its configs,
  ``launch/steps.py``) is in the scan, and importing it leaves ``jax``
  unloaded; every model's ``init`` and ``params_from_jax``, the sampler
  and ``steps.build`` raise without a GPU unless ``device="cpu"``, and the
  sampler refuses a graph on another device than the one asked for.
- The training path (``optim/``, ``data/``, ``checkpoint/``,
  ``runtime/fault_tolerance.py``, ``launch/train.py``) is in the scan,
  which also refuses ``ml_dtypes`` (the card's machine has none), and
  importing the trainer leaves ``jax`` unloaded; ``train.build`` and
  ``train.main`` without ``--device cpu`` raise without a GPU; the
  kernel route, forced or chosen, raises under autograd (it has no
  backward); ``prefill`` and ``decode`` of a model whose parameters
  require a gradient build no graph.
- The recsys family and the parallel substrate (``nn/embedding_bag.py``,
  ``models/dcn_v2.py``, ``configs/dcn_v2.py``, ``optim/compression.py``,
  ``parallel/``) are in the scan, and importing ``launch/steps.py``,
  ``optim/compression.py`` and ``parallel/pipeline.py`` leaves ``jax``
  unloaded; ``dcn_v2.init``, ``dcn_v2.params_from_jax`` and
  ``steps.build`` of a recsys cell raise without a GPU unless
  ``device="cpu"`` (``steps.recsys_cell`` is a config and takes no
  device).
- The paper cells and their dry-run (``configs/paper_bfs.py``,
  ``launch/hlo_analysis.py``, ``launch/dryrun.py``) are in the scan, and
  importing the dry-run leaves ``jax`` unloaded; a ``--mesh card`` run
  without a GPU records "CUDA is not available" and fails, and the cell
  builder needs a mesh on the card unless it is given ``"cpu"``.
- The GNN and recsys mesh cells (``launch/steps.py``'s ``_gnn_cell``,
  ``_recsys_cell``, the edge slabs of ``models/gnn/common.py``, the
  autograd collectives of ``core/collectives.py``) leave ``jax``
  unloaded when built and run; a cell on a mesh of the card raises
  without a GPU, and a ``--mesh card`` GNN record without ``--device
  cpu`` records "CUDA is not available".
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
from repro_torch.runtime.dispatch import QueryDispatcher
from repro_torch.runtime.scheduler import AdaptiveScheduler
from repro_torch.runtime.service import ServingLoop

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


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


MUTATION_MODULES = ("graph/delta.py", "runtime/service.py",
                    "runtime/dispatch.py", "runtime/scheduler.py",
                    "launch/serve.py", "launch/mesh.py",
                    "core/collectives.py", "graph/partition.py")
LM_MODULES = ("configs/__init__.py", "configs/base.py",
              "configs/minicpm_2b.py", "configs/deepseek_coder_33b.py",
              "configs/olmoe_1b_7b.py", "configs/gemma2_2b.py",
              "configs/llama4_maverick.py", "nn/__init__.py",
              "nn/module.py", "nn/layers.py", "nn/rope.py",
              "nn/attention.py", "nn/moe.py", "models/__init__.py",
              "models/transformer.py")
TRAIN_MODULES = ("optim/__init__.py", "optim/schedules.py", "optim/adamw.py",
                 "data/__init__.py", "data/pipeline.py",
                 "checkpoint/__init__.py", "checkpoint/checkpoint.py",
                 "runtime/fault_tolerance.py", "launch/train.py")
GNN_MODULES = ("graph/sampler.py", "models/gnn/__init__.py",
               "models/gnn/common.py", "models/gnn/schnet.py",
               "models/gnn/pna.py", "models/gnn/irreps.py",
               "models/gnn/mace.py", "models/gnn/equiformer_v2.py",
               "configs/schnet.py", "configs/pna.py", "configs/mace.py",
               "configs/equiformer_v2.py", "launch/steps.py")
RECSYS_MODULES = ("nn/embedding_bag.py", "models/dcn_v2.py",
                  "configs/dcn_v2.py", "optim/compression.py",
                  "parallel/__init__.py", "parallel/pipeline.py")
PAPER_MODULES = ("configs/paper_bfs.py", "launch/hlo_analysis.py",
                 "launch/dryrun.py")
MESH_LM_MODULES = ("nn/module.py", "models/transformer_mesh.py",
                   "launch/steps.py", "core/collectives.py")


def test_port_never_imports_jax_or_the_jax_package():
    files = port_files()
    assert len(files) > 20
    scanned = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
               for p in files if "repro_torch" in p.parts}
    assert set(MUTATION_MODULES) <= scanned
    assert set(LM_MODULES) <= scanned
    assert set(TRAIN_MODULES) <= scanned
    assert set(GNN_MODULES) <= scanned
    assert set(RECSYS_MODULES) <= scanned
    assert set(PAPER_MODULES) <= scanned
    assert set(MESH_LM_MODULES) <= scanned
    bad = [
        f"{p.relative_to(ROOT)}: {mod}"
        for p in files for mod in absolute_imports(p)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_serve_import_leaves_jax_unloaded():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, repro_torch.launch.serve, repro_torch.core, "
            "repro_torch.launch.mesh, repro_torch.core.collectives, "
            "repro_torch.runtime.scheduler, repro_torch.runtime.service, "
            "repro_torch.graph.delta, repro_torch.models.transformer, "
            "repro_torch.models.transformer_mesh, repro_torch.nn.module, "
            "repro_torch.launch.steps, repro_torch.launch.dryrun, "
            "repro_torch.configs.base; "
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
    for argv in (["--closed-loop", "--batches", "1"], ["--arrivals", "2"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(["--scale", "0.05", "--query-kind", "ppr", *argv])
    assert resolve_device("cpu") == torch.device("cpu")
    sched = AdaptiveScheduler("cpu", csr, phase1_iters=2)
    out = sched.query(np.array([0, 5], np.int32))
    assert out.result.state.levels.device.type == "cpu"


def test_open_loop_and_mutation_entry_points_raise_without_cuda(no_cuda):
    csr = erdos_renyi(64, 3.0, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingLoop(None, csr)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingLoop("cuda", csr)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        QueryDispatcher(None, csr)
    for argv in ([], ["--mutate-stream", "1"], ["--arrivals", "2"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(["--scale", "0.05", *argv])
    loop = ServingLoop("cpu", csr, max_iters=8)
    loop.submit(np.array([0, 5], np.int32), qid="a")
    assert loop.drain()["a"].shape == (2, 64)


def test_apply_delta_places_copies_on_the_device():
    from repro_torch.graph.delta import random_delta

    csr = erdos_renyi(200, 4.0, seed=2)
    d = QueryDispatcher("cpu", csr, max_iters=16)
    d.query(np.array([0, 7], np.int32), backend="dopt_fused")
    (bundle,) = d._graphs.values()
    rep = d.apply_delta(random_delta(csr, 10, 10, seed=1))
    assert rep.structures_changed > 0
    host, ops = bundle.host, bundle.ops
    for name in ("fwd", "rev_binned", "rev_binned_pack"):
        placed, mirror = getattr(ops, name), getattr(host, name)
        for a, b in zip(tensor_leaves(placed), tensor_leaves(mirror)):
            assert a.device.type == "cpu" and torch.equal(a, b)
            if a.numel():  # zero-width slabs own no storage
                assert a.data_ptr() != b.data_ptr(), name


def tensor_leaves(obj):
    import dataclasses

    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, tuple):
            out.extend(v)
    return out


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
    from repro_torch.kernels.binned_pull.ops import launch_record

    with pytest.raises(ValueError, match="CUDA"):
        fused_binned_pull(launch_record(pack), "reach", g)
    with pytest.raises(ValueError, match="CUDA"):
        msbfs_extend_blocks(kb.blocks, kb.block_rows, kb.block_cols,
                            lanes.reshape(2, 128, 64))
    with pytest.raises(ValueError, match="CUDA"):
        block_spmm(sb.nz, x)
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
    f = torch.tensor([0.5, 0.0, 0.25])
    assert merge_contribution("sum", f) is f
    # axis names reduce over a mesh's process groups: bare names have none
    with pytest.raises(ValueError, match="carry no mesh"):
        merge_contribution("sum", f, ("model",))
    with pytest.raises(ValueError, match="unknown merge"):
        merge_contribution("xor", x)
    with pytest.raises(ValueError, match="carry no mesh"):
        merge_contribution("or", x, ("model",))
    # the one-rank mesh's axes have size 1: every merge is the identity
    from repro_torch.launch.mesh import as_mesh

    axes = as_mesh("cpu").axes(("data", "model"))
    assert merge_contribution("or", x, axes) is x
    assert merge_contribution("sum", f, axes) is f


def test_mesh_entry_points_raise_without_cuda_unless_cpu(no_cuda):
    from repro_torch.launch.mesh import as_mesh, init_distributed, make_mesh

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        as_mesh(None)
    # NCCL puts the rank on its card: no card, no rank (and no fallback)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_distributed("nccl", "tcp://127.0.0.1:1", 0, 1)
    with pytest.raises(ValueError, match="nccl or gloo"):
        init_distributed("mpi", "tcp://127.0.0.1:1", 0, 1)
    # a mesh of several ranks needs its process group
    with pytest.raises(RuntimeError, match="torch.distributed"):
        make_mesh((2, 2), ("data", "model"), "cpu")
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    assert mesh.size == 1 and mesh.device.type == "cpu"
    csr = erdos_renyi(64, 3.0, seed=0)
    for layout in ("replicated", "sharded"):
        res = run_recursive_query(mesh, csr, [0, 5], policy_ntks(),
                                  state_layout=layout)
        assert res.state.levels.device.type == "cpu"



def test_lm_entry_points_raise_without_cuda_unless_cpu(no_cuda):
    from repro_torch.configs import base
    from repro_torch.models import transformer

    cfg = base.get("minicpm-2b").smoke_config()
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer.init(cfg, gen)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer.init(cfg, gen, "cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer.init_model_cache(cfg, 1, 16)
    model = transformer.init(cfg, gen, "cpu")
    tree = transformer.params_to_numpy(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transformer.params_from_jax(cfg, tree)
    assert model.embed.table.device.type == "cpu"
    # the full width costs nothing on the meta device, with or without GPU
    full = transformer.init(base.get("minicpm-2b").full_config(), None,
                            "meta")
    assert full.embed.table.shape == (122880, 2304)
    with pytest.raises(ValueError, match="Generator"):
        transformer.init(cfg, None, "cpu")


def test_lm_kernel_route_on_cpu_takes_the_plain_mha():
    from repro_torch.configs import base
    from repro_torch.models import transformer
    from repro_torch.nn import attention

    cfg = base.get("minicpm-2b").smoke_config()
    model = transformer.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 128)))
    launches = (flash_attention.launches,
                dict(flash_attention.route_launches))
    calls = dict(attention.route_calls)
    got, caches = transformer.prefill(model, cfg, toks, route="kernel")
    assert attention.route_calls == {
        "kernel": calls["kernel"] + cfg.n_layers, "scan": calls["scan"]}
    assert (flash_attention.launches,
            flash_attention.route_launches) == launches
    # unforced, a CPU tensor takes the scan route
    exp, _ = transformer.prefill(model, cfg, toks)
    assert attention.route_calls["scan"] == calls["scan"] + cfg.n_layers
    torch.testing.assert_close(got, exp, rtol=1e-5, atol=1e-4)
    assert caches[0].k.device.type == "cpu"


def test_train_import_leaves_jax_unloaded():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, repro_torch.launch.train, repro_torch.optim.adamw, "
            "repro_torch.optim.schedules, repro_torch.data.pipeline, "
            "repro_torch.checkpoint.checkpoint, "
            "repro_torch.runtime.fault_tolerance; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes')]; print(bad); "
            "raise SystemExit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_train_entry_points_raise_without_cuda_unless_cpu(no_cuda, tmp_path):
    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.build("minicpm-2b", True, 2, 16, 1e-3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.build("minicpm-2b", True, 2, 16, 1e-3, "cuda")
    argv = ["--steps", "1", "--batch", "2", "--seq", "16", "--ckpt-dir",
            str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(argv)
    assert not any(tmp_path.iterdir())  # nothing ran
    cfg, model, opt, *_ = train.build("minicpm-2b", True, 2, 16, 1e-3, "cpu")
    assert model.embed.table.device.type == "cpu"
    assert all(p.requires_grad for p in model.parameters())
    assert opt.mu["embed.table"].device.type == "cpu"


def test_kernel_route_refuses_autograd():
    """``mha`` has no backward: a kernel route, forced here (on the CPU
    its plain version would differentiate), raises while autograd records
    a gradient to q, k or v; under ``no_grad`` or with inputs that need no
    gradient it runs."""
    from repro_torch.nn import attention

    s = attention.AttnSettings(d_model=64, n_heads=4, n_kv_heads=2,
                               d_head=16)
    p = attention.attn_init(torch.Generator().manual_seed(0), s)
    p.requires_grad_(True)
    x = torch.randn(2, 128, 64)
    pos = torch.arange(128, dtype=torch.int32).expand(2, 128)
    calls = dict(attention.route_calls)
    with pytest.raises(RuntimeError, match="no backward"):
        attention.attention(p, s, x, pos, route="kernel")
    q = torch.randn(2, 128, 4, 16, requires_grad=True)
    kv = torch.randn(2, 128, 2, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        attention.attend(p, s, q, kv, kv, pos, route="kernel")
    assert attention.route_calls == calls  # refused before counting
    with torch.no_grad():
        attention.attention(p, s, x, pos, route="kernel")
    assert attention.route_calls["kernel"] == calls["kernel"] + 1
    # the scan route differentiates, and reaches wq
    attention.attention_scan(p, s, x, pos).sum().backward()
    assert p.wq.kernel.grad is not None and p.wq.kernel.grad.abs().sum() > 0


def test_trained_model_serves_without_a_graph():
    from repro_torch.configs import base
    from repro_torch.models import transformer

    cfg = base.get("minicpm-2b").smoke_config()
    model = transformer.init(cfg, torch.Generator().manual_seed(0), "cpu")
    model.requires_grad_(True)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 128)))
    for route in (None, "kernel"):
        last, caches = transformer.prefill(model, cfg, toks, max_seq=130,
                                           route=route)
        assert last.grad_fn is None and not last.requires_grad
        assert all(not c.k.requires_grad for c in caches)
        out, caches = transformer.decode(model, cfg, caches, toks[:, :1], 128)
        assert out.grad_fn is None and not out.requires_grad
    assert model.embed.table.grad is None


def test_gnn_import_leaves_jax_unloaded():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, repro_torch.launch.steps, repro_torch.graph.sampler, "
            "repro_torch.models.gnn.irreps, repro_torch.configs.base as b; "
            "b.all_archs(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes')]; print(bad); "
            "raise SystemExit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("arch", ["equiformer-v2", "mace", "pna", "schnet"])
def test_gnn_entry_points_raise_without_cuda_unless_cpu(arch, no_cuda):
    from repro_torch.configs import base
    from repro_torch.launch import steps
    from repro_torch.models.gnn import common

    mod = steps.GNN_MODULES[arch]
    cfg = base.get(arch).smoke_config()
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.init(cfg, gen)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.init(cfg, gen, "cuda")
    model = mod.init(cfg, gen, "cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())
    tree = common.params_to_numpy(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.params_from_jax(cfg, tree)
    back = mod.params_from_jax(cfg, tree, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 back.parameters()))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        steps.build(arch, "molecule", gen, smoke=True)
    cell, model, opt, step = steps.build(arch, "molecule", gen, "cpu",
                                         smoke=True, dims=dict(batch=2))
    _, opt, loss, gnorm = step(model, opt, steps.batch_to(
        steps.cell_batch(cell), "cpu"))
    assert loss.device.type == "cpu" and bool(torch.isfinite(loss))
    # the full width costs nothing on the meta device
    full = mod.init(base.get(arch).full_config(), None, "meta")
    assert all(p.device.type == "meta" for p in full.parameters())
    with pytest.raises(ValueError, match="Generator"):
        mod.init(cfg, None, "cpu")


def test_sampler_follows_the_device_rule(no_cuda):
    from repro_torch.graph.csr import ell_from_csr
    from repro_torch.graph.sampler import sample_subgraph

    g = ell_from_csr(erdos_renyi(64, 3.0, seed=0))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sample_subgraph(g, [0, 5], (3, 2), gen)
    sub = sample_subgraph(g, [0, 5], (3, 2), gen, device="cpu")
    assert sub.nodes.device.type == "cpu" and sub.nodes.shape == (2 + 6 + 12,)
    with pytest.raises(ValueError, match="Generator or raw_slots"):
        sample_subgraph(g, [0, 5], (3, 2), device="cpu")


def test_sampler_refuses_a_graph_on_another_device():
    from repro_torch.graph.csr import ell_from_csr
    from repro_torch.graph.sampler import sample_subgraph
    from repro_torch.kernels.common import map_tensors

    g = map_tensors(lambda t: t.to("meta"), ell_from_csr(
        erdos_renyi(64, 3.0, seed=0)))
    with pytest.raises(ValueError, match="lies on meta"):
        sample_subgraph(g, [0], (2,), torch.Generator(), device="cpu")


def test_recsys_and_parallel_imports_leave_jax_unloaded():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, repro_torch.launch.steps, "
            "repro_torch.optim.compression, repro_torch.parallel.pipeline, "
            "repro_torch.nn.embedding_bag, repro_torch.configs.base as b; "
            "b.get('dcn-v2'); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes')]; print(bad); "
            "raise SystemExit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("shape", ["train_batch", "serve_p99",
                                   "retrieval_cand"])
def test_recsys_entry_points_raise_without_cuda_unless_cpu(shape, no_cuda):
    from repro_torch.configs import base
    from repro_torch.launch import steps
    from repro_torch.models import dcn_v2
    from repro_torch.models.gnn.common import params_to_numpy

    cfg = base.get("dcn-v2").smoke_config()
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dcn_v2.init(cfg, gen)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dcn_v2.init(cfg, gen, "cuda")
    model, off = dcn_v2.init(cfg, gen, "cpu")
    assert off.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in model.parameters())
    tree = params_to_numpy(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dcn_v2.params_from_jax(tree, cfg)
    back, _ = dcn_v2.params_from_jax(tree, cfg, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                 back.parameters()))
    dims = dict(batch=4, n_candidates=200)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        steps.build("dcn-v2", shape, gen, smoke=True, dims=dims)
    cell, model, opt, step = steps.build("dcn-v2", shape, gen, "cpu",
                                         smoke=True, dims=dims)
    b = steps.batch_to(steps.recsys_batch(cell), "cpu")
    if cell.kind == "train":
        _, opt, loss, _ = step(model, opt, b)
        assert loss.device.type == "cpu" and bool(torch.isfinite(loss))
    elif cell.kind == "retrieval":
        assert opt is None
        cand = steps.retrieval_candidates(cell, gen)
        _, idx = step(model, b, cand)
        assert idx.device.type == "cpu"
        assert idx.shape == (4, steps.RETRIEVAL_TOP_K)
    else:
        assert opt is None and step(model, b).shape == (4,)
    # the full width costs nothing on the meta device
    full, _ = dcn_v2.init(base.get("dcn-v2").full_config(), None, "meta")
    assert all(p.device.type == "meta" for p in full.parameters())
    with pytest.raises(ValueError, match="Generator"):
        dcn_v2.init(cfg, None, "cpu")


def test_dryrun_import_leaves_jax_unloaded():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, repro_torch.launch.dryrun, "
            "repro_torch.launch.hlo_analysis, repro_torch.configs.paper_bfs; "
            "repro_torch.launch.dryrun.iter_cells(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes')]; print(bad); "
            "raise SystemExit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_paper_cell_entry_points_raise_without_cuda(no_cuda, tmp_path):
    import json

    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_mesh

    rc = dryrun.main(["--arch", "paper-bfs-engine", "--shape", "ldbc100",
                      "--mesh", "card", "--out", str(tmp_path)])
    assert rc == 1
    rec = json.loads((tmp_path / "paper-bfs-engine__ldbc100__card.json")
                     .read_text())
    assert rec["status"] == "error"
    assert "CUDA is not available" in rec["error"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh((1, 1), ("data", "model"))
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    cell = steps.build_cell("paper-bfs-engine", "ldbc100", mesh, False)
    assert cell.fn.device.type == "cpu"
    assert cell.args[0].indices.device.type == "meta"


def test_mesh_cells_leave_jax_unloaded_and_need_the_card(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = (
        "import sys, torch\n"
        "from repro_torch.launch import steps\n"
        "from repro_torch.launch.mesh import make_mesh, "
        "make_production_mesh\n"
        "from repro_torch.optim.adamw import adamw_init\n"
        "for a, s in steps.cfgbase.all_cells()[0]:\n"
        "    if steps.cfgbase.get(a).family in ('gnn', 'recsys'):\n"
        "        steps.build_cell(a, s, make_production_mesh(), False)\n"
        "mesh = make_mesh((1, 1), ('data', 'model'), 'cpu')\n"
        "cell = steps.build_cell('schnet', 'molecule', mesh, False, "
        "smoke=True, dims=dict(batch=2))\n"
        "gc = steps.gnn_cell('schnet', 'molecule', smoke=True, "
        "dims=dict(batch=2))\n"
        "m = steps.shard_gnn(cell, steps.init_model(gc, "
        "torch.Generator().manual_seed(0), 'cpu'), mesh)\n"
        "b, _ = steps.gnn_rank_batch(cell, mesh, steps.pad_gnn_batch("
        "cell, steps.cell_batch(gc)))\n"
        "cell.fn(m, adamw_init(steps.params_dict(m), steps.GNN_ADAMW), b)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'ml_dtypes')]; print(bad)\n"
        "raise SystemExit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_mesh_cells_raise_without_cuda_unless_cpu(tmp_path, no_cuda):
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_mesh

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        steps.build_cell("pna", "molecule", make_mesh(
            (1, 1), ("data", "model")), False)
    assert dryrun.main(["--arch", "schnet", "--shape", "molecule",
                        "--mesh", "card", "--out", str(tmp_path)]) == 1
    rec = dryrun.run_cell("schnet", "molecule", "card", str(tmp_path))
    assert "CUDA is not available" in rec["error"]
