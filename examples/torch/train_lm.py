"""End-to-end driver on the PyTorch port: train a ~100M-parameter
qwen2.5-family model for a few hundred steps with the full production
stack -- seeded init, deterministic prefetched data, AdamW, grad
accumulation, asynchronous checkpointing, preemption guard, crash retry.

  PYTHONPATH=src python examples/torch/train_lm.py [--steps 300]
  PYTHONPATH=src python examples/torch/train_lm.py --device cpu --smoke \\
      --steps 3 --batch 2 --seq 16

The ~100M config is the real qwen2_5_3b block structure at reduced width
(d_model 768, 12 layers), i.e. a genuine member of the same family, not a
toy; --smoke trains the registry's smoke config of qwen2_5_3b instead. A
rerun with the same --ckpt-dir resumes from its last checkpoint.
`main(argv)` returns the parameter count and the losses.
"""

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch import configs as cfglib
from repro_torch.launch.train import train


def pick_device(name: str) -> torch.device:
    """--device's device; the card is the default and is never replaced by
    the CPU on its own."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the plain PyTorch versions on the CPU")
    return dev


def make_config(seq: int, smoke: bool):
    """The ~100M qwen2.5 (or, with `smoke`, the registry's smoke config)
    for sequences of `seq` tokens."""
    if smoke:
        base = cfglib.get_smoke_config("qwen2_5_3b")
        return dataclasses.replace(base, max_seq=max(base.max_seq, seq))
    # ~100M params: 12 x (d=768, ff=2048, 12 heads GQA kv=2) + 32k vocab
    base = cfglib.get_config("qwen2_5_3b")
    return dataclasses.replace(
        base, n_layers=12, d_model=768, n_heads=12, n_kv_heads=2,
        head_dim=64, d_ff=2048, vocab=32_768, max_seq=seq, logits_chunk=128)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train_lm"))
    ap.add_argument("--smoke", action="store_true",
                    help="the registry's smoke config instead of ~100M")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = pick_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = make_config(args.seq, args.smoke)
    n = cfg.n_params
    label = "smoke" if args.smoke else "100m"
    print(f"[example] training {cfg.name}-{label}: {n/1e6:.0f}M params, "
          f"{args.steps} steps @ batch {args.batch} x seq {args.seq}")
    _, history = train(cfg.name, config=cfg, steps=args.steps,
                       batch=args.batch, seq=args.seq, smoke=False,
                       ckpt_dir=args.ckpt_dir, ckpt_every=100, accum=2,
                       lr=1e-3, log_every=20, device=dev)
    if not history:
        print(f"[example] {args.ckpt_dir} already holds step {args.steps}; "
              f"nothing to train")
        return {"params": n, "losses": history}
    print(f"[example] loss {history[0]:.3f} -> {history[-1]:.3f} "
          f"({100*(1-history[-1]/history[0]):.0f}% reduction)")
    if not history[-1] < history[0]:
        raise RuntimeError(f"training must reduce loss: {history}")
    return {"params": n, "losses": history}


if __name__ == "__main__":
    main()
