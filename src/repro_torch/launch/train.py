"""Training launcher -- on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/run1

    # the plain PyTorch path on the CPU, at test size
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \
        --reduced --device cpu --steps 20 --batch 4 --seq 32 --eval

Any --arch of the port's registry works; --reduced swaps in the CPU-scale
config of the same family.  The model trains on the synthetic Zipf-Markov
stream (``data/synthetic.py``) through the plain PyTorch paths (no kernel
has a backward).  Restarting the same command auto-resumes from the last
checkpoint (fault tolerance path; see training/loop.py).
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.data import data_config_for
from repro_torch.models.common import resolve_device
from repro_torch.models.opts import ModelOpts
from repro_torch.optim import AdamW
from repro_torch.training import eval_perplexity, train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the CPU-scale reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", action="store_true",
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval", action="store_true",
                    help="report held-out perplexity after training")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dc = data_config_for(cfg, seq_len=args.seq, global_batch=args.batch,
                         seed=args.seed)
    optimizer = AdamW(peak_lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 20, 5))

    print(f"arch={cfg.name} params={cfg.param_count():,} device={dev}")
    result = train(cfg, dc, total_steps=args.steps, optimizer=optimizer,
                   opts=ModelOpts(remat=args.remat),
                   ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                   resume=not args.no_resume, seed=args.seed,
                   microbatches=args.microbatches,
                   compression=args.compression, verbose=True, device=dev)
    print(f"ran {result.steps_run} steps; final loss "
          f"{result.losses[-1] if result.losses else float('nan'):.4f}; "
          f"stragglers flagged: {result.straggler_steps}")
    if args.eval:
        ppl = eval_perplexity(result.state, cfg, dc)
        print(f"held-out perplexity: {ppl:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
