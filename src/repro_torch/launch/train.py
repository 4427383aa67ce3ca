"""Config-driven fault-tolerant training driver (port of
``repro.launch.train``).

End-to-end: arch config -> seeded model -> sharded data stream -> eager
train step (forward with the scan attention route, backward, AdamW in
place, gradients zeroed) -> ``TrainGuard`` loop (checkpoint every N in
JAX's on-disk format, crash-resume, straggler EWMA). The LM family only,
as in JAX.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --steps 20 --batch 4 --seq 32 --ckpt-dir /tmp/ckpt --save-every 10

The flags and defaults are JAX's, plus ``--device`` (``cuda`` unless
``--device cpu``; without a GPU the default raises). As in JAX,
``--smoke`` is ``store_true`` with default True, so the command line runs
the smoke config; ``build(arch, smoke=False, ...)`` reaches the full one.
Weights come from a ``torch.Generator`` seeded 0 on the target device, so
they differ from JAX's ``PRNGKey(0)`` weights and between devices;
``models.transformer.state_from_jax`` carries JAX's state across.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..checkpoint.checkpoint import CheckpointManager
from ..configs import base as cfgbase
from ..data.pipeline import TokenStream
from ..kernels.common import resolve_device
from ..models import transformer as tfm
from ..nn.module import count_params
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..optim.schedules import cosine_schedule, wsd_schedule
from ..runtime.fault_tolerance import StragglerDetector, TrainGuard


@dataclasses.dataclass
class TrainState:
    params: object
    opt: object
    step: int = 0


def make_train_step(cfg, ocfg: AdamWConfig):
    """``train_step(model, opt, batch, lr_scale) -> (model, opt, loss,
    grad_norm)``: forward (``loss_fn``, the scan attention route) and
    backward, AdamW on the parameters and moments in place, then the
    gradients set to None (their memory is free until the next
    backward)."""

    def train_step(model, opt, batch, lr_scale):
        loss = tfm.loss_fn(model, cfg, batch)
        loss.backward()
        params = dict(model.named_parameters())
        _, opt, gnorm = adamw_update(
            {k: p.grad for k, p in params.items()}, opt, params, ocfg,
            lr_scale=lr_scale)
        model.zero_grad(set_to_none=True)
        return model, opt, loss.detach(), gnorm

    return train_step


def build(arch: str, smoke: bool, batch: int, seq: int, lr: float,
          device=None, n_layers: int | None = None):
    """(cfg, model, opt, sched, stream, train_step); the model's
    parameters require a gradient, ``train_step`` is
    ``make_train_step``'s. ``n_layers``, if given, cuts the config's
    depth (its widths kept)."""
    dev = resolve_device(device)
    spec = cfgbase.get(arch)
    if spec.family != "lm":
        raise ValueError(f"train.py drives the LM family, not {spec.family}")
    cfg = spec.smoke_config() if smoke else spec.full_config()
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = tfm.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    model.requires_grad_(True)
    ocfg = AdamWConfig(lr=lr)
    opt = adamw_init(dict(model.named_parameters()), ocfg)
    sched = (
        wsd_schedule(warmup=20, total=10_000)
        if spec.schedule == "wsd"
        else cosine_schedule(warmup=20, total=10_000)
    )
    stream = TokenStream(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    return cfg, model, opt, sched, stream, make_train_step(cfg, ocfg)


def device_batch(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg, model, opt, sched, stream, train_step = build(
        args.arch, args.smoke, args.batch, args.seq, args.lr, args.device
    )
    dev = next(model.parameters()).device
    print(f"{cfg.name}: {count_params(model)/1e6:.1f}M params")
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    detector = StragglerDetector()
    guard = TrainGuard(
        ckpt=ckpt, save_every=args.save_every, detector=detector
    )

    # the state tree holds the model's and the optimizer's own tensors:
    # a restore (here, or the guard's after a failed step) writes them in
    # place, so the step function trains on whatever was restored
    live = {"opt": opt}
    state = tfm.state_tree(model, opt)
    start = 0
    latest = ckpt.latest_step()
    if latest is not None:
        state, start = ckpt.restore(state)[0], latest
        print(f"resumed from step {start}")

    losses = []

    def step_fn(state, step):
        batch = device_batch(stream.batch(step), dev)
        lr_scale = sched(step)
        _, o, loss, gnorm = train_step(model, live["opt"], batch, lr_scale)
        live["opt"] = o
        if step % args.log_every == 0:
            print(
                f"step {step:5d}  loss {float(loss):.4f}  "
                f"gnorm {float(gnorm):.3f}  lr x{float(lr_scale):.3f}"
            )
        losses.append(float(loss))
        return tfm.state_tree(model, o)

    t0 = time.time()
    state, end = guard.run(state, step_fn, args.steps, start_step=start)
    dt = time.time() - t0
    tok_s = (end - start) * args.batch * args.seq / max(dt, 1e-9)
    print(
        f"done: steps {start}->{end} in {dt:.1f}s ({tok_s:.0f} tok/s); "
        f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
        f"stragglers flagged: {len(detector.incidents)}"
    )
    ckpt.wait()
    if not losses[-1] < losses[0]:
        raise AssertionError("training must descend")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
