"""Training launcher of the port — the twin of ``repro/launch/train.py``.

    # reduced tinyllama on a (2, 4) virtual mesh, on the CPU
    python -m repro_torch.launch.train --arch tinyllama-1.1b --reduced \
        --mesh-shape 2 4 --steps 4 --batch 4 --seq 32 --device cpu

The ranks of ``--mesh-shape`` are virtual ranks of one device
(``core/pgl.py``). As in JAX, FSDP is on whenever there is a mesh: every
weight gather runs ``CommContext.all_gather`` over the data axis and every
gradient reduction its reduce-scatter (the ring kernels with
``comm_backend="fused"``). The entry points run on ``cuda`` unless
``device`` names another device; with no GPU and no device they raise.
Every decoder family trains: dense, MoE, SSM and hybrid. An
encoder-decoder is refused (no data pipeline feeds its frames, in JAX
either). ``--comm-wire int8`` (or ``int8_sr``) ships the GEMM-collective
rings' payloads quantized (``core/quant.py``); ``--compress-grads`` runs
int8 gradient compression with error feedback
(``optim.compress.ErrorFeedbackInt8``) on the accumulated gradient before
each update.

Where the port and JAX part: JAX's launcher keeps the error-feedback state
in a dict that the function it jits reads and writes, so ``jax.jit``
traces the residual once as a constant (zeros) and every step compresses
without feedback (ROADMAP C14). The port carries the residual from step to
step, as ``ErrorFeedbackInt8`` is specified to: it is the train state's
``grad_state``, threaded through ``make_train_step`` and saved in the
checkpoint with the rest of the state.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.compat import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.core.pgl import VirtualMesh
from repro_torch.core.template import render_plans
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import transformer as T
from repro_torch.models.layers import island_plans
from repro_torch.models.sharding import ShardingRules
from repro_torch.optim.adamw import AdamW, warmup_cosine
from repro_torch.optim.compress import ErrorFeedbackInt8
from repro_torch.runtime.driver import DriverConfig, TrainDriver
from repro_torch.train.step import TrainState, make_train_step


def build_and_train(arch: str, *, steps: int, reduced: bool, mesh_shape,
                    mesh_axes=("data", "model"), batch: int, seq: int,
                    ckpt_dir: str, lr: float = 3e-3, microbatches: int = 1,
                    pk_overlap: bool = True, compress_grads: bool = False,
                    fault_hook=None, seed: int = 0, log_every: int = 10,
                    ckpt_every: int = 50, comm_policy: str = "analytic",
                    comm_chunks: int | None = None, ulysses_chunks: int = 1,
                    comm_wire: str | None = None,
                    comm_backend: str | None = None, device=None):
    """Config -> random parameters (``torch.Generator`` seeded with
    ``seed``) -> AdamW (warmup-cosine) -> ``TrainDriver``; returns
    (state, metrics_log). ``comm_backend`` pins every CommContext backend
    (``"fused"``: the ring kernels for every FSDP gather and gradient).
    ``compress_grads``: int8 error-feedback compression of each step's
    gradient, its residual in ``state.grad_state`` (the global layout of
    every weight, f32)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if cfg.encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the launcher's data pipeline feeds no enc_embeds "
            "(nor does the JAX launcher's); train an encoder-decoder through "
            "models.transformer.forward_train or train.step.make_train_step "
            "with an enc_embeds batch")
    mesh = VirtualMesh(mesh_shape, mesh_axes, dev) if mesh_shape else None
    run = RunConfig(dp_axes=tuple(a for a in (mesh_axes or ())
                                  if a != "model") or ("data",),
                    pk_overlap=pk_overlap, microbatches=microbatches,
                    fsdp=mesh is not None, comm_policy=comm_policy,
                    comm_chunks=comm_chunks, ulysses_chunks=ulysses_chunks,
                    comm_wire=comm_wire, comm_backend=comm_backend)
    rules = ShardingRules(mesh, run) if mesh is not None else None
    if rules is not None:
        print(f"[plan] comm_policy={run.comm_policy}")
        print(render_plans(island_plans(cfg, run, rules, batch=batch,
                                        seq=seq)))

    tmpl = T.param_template(cfg, run, rules)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = T.init_params(tmpl, gen, cfg.d_model, rules=rules, device=dev)
    opt = AdamW(lr=warmup_cosine(lr, max(10, steps // 20), steps),
                weight_decay=0.01)
    grad_transform = grad_state = None
    if compress_grads:
        ef = ErrorFeedbackInt8()
        grad_transform = ef.transform
        grad_state = ef.init(T.zeros(tmpl, None, dev))   # global shapes
    state = TrainState(params=params, opt=opt.init(params),
                       grad_state=grad_state)
    step_fn = make_train_step(cfg, run, rules, opt,
                              grad_transform=grad_transform)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                  global_batch=batch, seed=seed), device=dev)
    driver = TrainDriver(
        train_step=step_fn, state=state, data=data, ckpt_dir=ckpt_dir,
        cfg=DriverConfig(total_steps=steps, ckpt_every=ckpt_every,
                         log_every=log_every),
        fault_hook=fault_hook)
    return driver.run()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh-shape", type=int, nargs="*", default=None)
    ap.add_argument("--mesh-axes", type=str, nargs="*",
                    default=["data", "model"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="build/repro_torch_ckpt")
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 gradient compression with error feedback")
    ap.add_argument("--no-pk", action="store_true")
    ap.add_argument("--comm-policy", default="analytic",
                    choices=["analytic", "measured", "auto"],
                    help="cost source for comm backend dispatch: measured "
                         "reads this device's calibration table "
                         "(python -m repro_torch.autotune calibrate)")
    ap.add_argument("--comm-chunks", type=int, default=None,
                    help="force the ring GEMM-collective sub-chunk count")
    ap.add_argument("--ulysses-chunks", type=int, default=1,
                    help="a2a chunk count for the Ulysses attention island")
    ap.add_argument("--comm-wire", default=None,
                    choices=["bf16", "int8", "int8_sr"],
                    help="GEMM-collective ring wire format: int8 ships "
                         "quantized payloads + f32 scales (int8_sr adds "
                         "stochastic rounding); default full precision")
    ap.add_argument("--comm-backend", default=None,
                    help="pin one CommContext backend (bulk/ring/fused)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the virtual ranks share")
    args = ap.parse_args(argv)
    build_and_train(args.arch, steps=args.steps, reduced=args.reduced,
                    mesh_shape=args.mesh_shape, mesh_axes=args.mesh_axes,
                    batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                    lr=args.lr, microbatches=args.microbatches,
                    pk_overlap=not args.no_pk,
                    compress_grads=args.compress_grads,
                    comm_policy=args.comm_policy,
                    comm_chunks=args.comm_chunks,
                    ulysses_chunks=args.ulysses_chunks,
                    comm_wire=args.comm_wire,
                    comm_backend=args.comm_backend, device=args.device)


if __name__ == "__main__":
    main()
