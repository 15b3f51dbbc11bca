"""Training driver (the port of ``repro.launch.train``).

Trains an architecture of ``configs.ARCH_IDS`` on the synthetic token
stream, at its published widths and in its dtype (bf16 at full width;
--reduced gives the 2-layer f32 test variant), on --device (default
cuda), with random initial weights from --seed. With --ckpt it saves
every --ckpt-every steps and at the end, and resumes from the step a
checkpoint there records.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --steps 30 --batch 8 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --reduced --device cpu --steps 8 --batch 2 --seq 32 --ckpt ck
"""
from __future__ import annotations

import argparse
import time

from ..compat import resolve_device
from ..configs import ARCH_IDS, get_config
from ..data import DataConfig, SyntheticTokens
from ..models import reduced as reduce_cfg
from ..train import (AdamWConfig, checkpoint_step, init_train_state,
                     make_train_step, restore_checkpoint, save_checkpoint)


def main(argv=None) -> dict:
    """Run the loop; returns each step's ``loss``, ``grad_norm``, ``lr``
    and wall seconds (``step_s``, from one host read of the step's loss
    to the next), and ``start_step``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config for CPU debug runs")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    cfg.validate()
    dev = resolve_device(args.device)

    data = SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq,
                                      batch_size=args.batch))
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                          total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg, microbatch=args.microbatch)

    state = init_train_state(cfg, seed=args.seed, device=dev)
    start_step = 0
    if args.ckpt and checkpoint_step(args.ckpt) is not None:
        start_step = checkpoint_step(args.ckpt)
        state = restore_checkpoint(args.ckpt, state)
        print(f"resumed from step {start_step}")

    log = {"start_step": start_step, "loss": [], "grad_norm": [], "lr": [],
           "step_s": []}
    t0 = last = time.time()
    for step in range(start_step, args.steps):
        batch = {"tokens": data.batch(step)["tokens"]}
        state, metrics = step_fn(state, batch)
        log["loss"].append(float(metrics["loss"]))   # one host read a step
        now = time.time()
        log["step_s"].append(now - last)
        last = now
        log["grad_norm"].append(float(metrics["grad_norm"]))
        log["lr"].append(float(metrics["lr"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {log['loss'][-1]:.4f} "
                  f"gnorm {log['grad_norm'][-1]:.3f} "
                  f"lr {log['lr'][-1]:.2e} [{now - t0:.1f}s]", flush=True)
        if args.ckpt and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt, state, step=step + 1)
    if args.ckpt:
        save_checkpoint(args.ckpt, state, step=args.steps)
    print("done")
    return log


if __name__ == "__main__":
    main()
