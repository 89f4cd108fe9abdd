"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 100 --global-batch 8 --seq-len 256 --smoke --device cpu \\
        --scheme seda --ckpt-dir /tmp/ckpt --ckpt-every 50

Mirrors the reference launcher (``repro.launch.train``), flag for flag:

  * any arch of :mod:`repro_torch.configs` (``--arch``), the smoke
    config (``--smoke``) or the published one;
  * the SeDA boundary: under ``--scheme`` other than ``off`` the params
    live protected between steps (:class:`SecureExecutor`; on the card
    the narrow B-AES and the NH MACs run the CUDA kernels), and a failed
    entry check aborts with ``INTEGRITY FAILURE``, and so does a failed
    check of the protected params before a checkpoint is written (the
    reference writes that checkpoint); checkpoints are always encrypted
    and MACed;
  * resume: ``--ckpt-dir`` restarts from the newest published checkpoint
    and the data pipeline's step.  As in the reference, a checkpoint
    holds the params and the data state only, so a resumed run restarts
    AdamW's moments and warmup (ROADMAP C);
  * a straggler watchdog: steps slower than ``--straggler-factor`` x
    the wall-time EWMA are logged.

Runs on the card unless ``--device cpu``; there is no fallback.  Fresh
weights are random, from a ``torch.Generator`` seeded with ``--seed``
(not the reference's JAX draw).
"""

from __future__ import annotations

import argparse
import os
import time

from repro_torch import resolve_device
from repro_torch.checkpoint.secure_ckpt import (latest_step, load_checkpoint,
                                                save_checkpoint)
from repro_torch.configs import OPT_DTYPE_OVERRIDES, get_arch
from repro_torch.core.secure_exec import SecureExecutor
from repro_torch.core.secure_memory import SecureKeys
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import encdec as ed
from repro_torch.models import lm as lm_mod
from repro_torch.models.layers import init_params
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import (make_secure_train_step,
                                          make_train_step)

__all__ = ["build", "main"]


def build(arch_name: str, smoke: bool) -> tuple:
    """``(arch, cfg, specs)``."""
    arch = get_arch(arch_name)
    cfg = arch.make_smoke_config() if smoke else arch.make_config()
    specs = (ed.encdec_specs(cfg) if arch.kind == "encdec"
             else lm_mod.lm_specs(cfg))
    return arch, cfg, specs


def _checkpoint_params(executor, state, region, step: int):
    """The params a checkpoint of ``step`` saves: ``state`` itself under
    ``off``, else the protected state decrypted and checked.  A failed
    check raises the step loop's ``INTEGRITY FAILURE`` before anything
    is written; the reference drops the verdict here and re-encrypts a
    tampered state into a checkpoint that loads as verified (ROADMAP
    C1)."""
    if executor.cfg.name == "off":
        return state
    params, ok = executor.unprotect(state, region)
    if not bool(ok):
        raise RuntimeError(
            f"INTEGRITY FAILURE at step {step}: protected params failed "
            f"their layer-MAC check before the checkpoint — aborting, "
            f"nothing written")
    return params


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scheme", default="off",
                    help="per-step secure boundary (off|seda|mgx64|sgx64|...)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    arch, cfg, specs = build(args.arch, args.smoke)
    opt_cfg = AdamWConfig(
        lr=args.lr,
        state_dtype=OPT_DTYPE_OVERRIDES.get(args.arch, "float32")
        if not args.smoke else "float32")

    n_patches = getattr(cfg, "n_image_patches", 0)
    data_cfg = DataConfig(
        vocab=cfg.vocab, seq_len=args.seq_len, global_batch=args.global_batch,
        seed=args.seed,
        kind=("encdec" if arch.kind == "encdec"
              else ("vlm" if n_patches else "lm")),
        n_image_patches=n_patches, d_vision=getattr(cfg, "d_vision", 0),
        d_model=cfg.d_model, src_len=max(8, args.seq_len // 2))
    data = SyntheticLM(data_cfg, device=device)

    keys = SecureKeys.derive(args.seed, device=device)
    start_step = 0
    params = None
    if args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            path = os.path.join(args.ckpt_dir, f"step_{last:08d}")
            params, manifest = load_checkpoint(path, specs, keys,
                                               device=device)
            start_step = manifest["extra_state"]["data"]["step"]
            data.load_state_dict(manifest["extra_state"]["data"])
            print(f"[train] resumed from {path} at step {start_step} "
                  f"(integrity verified)")
    if params is None:
        params = init_params(specs, args.seed, device=device)
    opt = init_opt_state(params, opt_cfg)

    executor = SecureExecutor(scheme=args.scheme, keys=keys)
    region = executor.region_spec(params)
    if args.scheme == "off":
        step_fn = make_train_step(arch, cfg, opt_cfg)
        state = params
    else:
        # The optimizer state stays outside the boundary (it never leaves
        # device memory in this threat model), as in the reference.
        step_fn = make_secure_train_step(arch, cfg, opt_cfg, executor,
                                         region)
        state = executor.protect(params, region, step=start_step)
    params = None              # under a scheme, only the protected copy

    ewma = None
    history = []
    for step in range(start_step, args.steps):
        batch = next(data)
        t0 = time.perf_counter()
        if args.scheme == "off":
            state, opt, metrics = step_fn(state, opt, batch)
        else:
            state, opt, metrics = step_fn(state, opt, batch, step)
            if not bool(metrics["integrity_ok"]):
                raise RuntimeError(
                    f"INTEGRITY FAILURE at step {step}: protected params "
                    f"failed their layer-MAC check — aborting")
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
        if dt > args.straggler_factor * ewma and step > start_step + 3:
            print(f"[train][straggler] step {step} took {dt:.2f}s "
                  f"(ewma {ewma:.2f}s)")
        history.append(loss)
        if step % args.log_every == 0:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"({dt * 1e3:.0f} ms)")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            p = _checkpoint_params(executor, state, region, step + 1)
            path = save_checkpoint(args.ckpt_dir, step + 1, p, keys,
                                   extra_state={"data": data.state_dict()})
            print(f"[train] secure checkpoint -> {path}")

    if args.ckpt_dir:
        p = _checkpoint_params(executor, state, region, args.steps)
        save_checkpoint(args.ckpt_dir, args.steps, p, keys,
                        extra_state={"data": data.state_dict()})
    return {"first_loss": history[0] if history else None,
            "last_loss": history[-1] if history else None,
            "steps": len(history)}


if __name__ == "__main__":
    out = main()
    print(f"[train] done: {out}")
