#!/usr/bin/env python3
"""Offline vocabulary training tool of the PyTorch/CUDA port.

The twin of train_vocab.py over asdslam_torch: collect descriptors from one
or more saved .map checkpoints, train the hierarchical k-means vocabulary on
the device ("cuda" unless ``--device cpu``), save it as the .npz that
``--voc_addr`` of run_slam_torch.py (and of run_slam.py) loads.  The random
picks of empty parents come from a torch generator seeded with ``--seed``.

Examples:
  python train_vocab_torch.py --map_addr run.map --out voc.npz
  python train_vocab_torch.py --map_addr a.map --map_addr b.map --out voc.npz \
      --branching 10 --depth 4
"""

import argparse

import numpy as np


def collect_descriptors_from_map(path: str) -> np.ndarray:
    from asdslam_torch.mapping import persistence

    data = persistence.load_visual_map(path)
    descs = []
    for fr in data.frames:
        d = np.asarray(fr["descriptors"], np.float32)
        if len(d):
            descs.append(d)
    if not descs:
        return np.zeros((0, 128), np.float32)
    return np.concatenate(descs, axis=0)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--map_addr", action="append", required=True,
                   help="saved .map checkpoint(s) to harvest descriptors from")
    p.add_argument("--out", required=True, help="output vocabulary .npz")
    p.add_argument("--branching", type=int, default=10)
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--max_descriptors", type=int, default=200000,
                   help="subsample cap (uniform) for k-means training")
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    import torch
    from asdslam_torch.loop import vocab as vocab_mod
    from asdslam_torch.system import require_device

    device = require_device(args.device)
    D = np.concatenate([collect_descriptors_from_map(m) for m in args.map_addr])
    # drop zero rows (padding)
    D = D[np.linalg.norm(D, axis=1) > 1e-6]
    if len(D) < 1000:
        raise SystemExit(f"too few descriptors ({len(D)}) to train a vocabulary")
    if len(D) > args.max_descriptors:
        sel = np.random.default_rng(args.seed).choice(len(D), args.max_descriptors,
                                                      replace=False)
        D = D[sel]
    print(f"training {args.branching}^{args.depth} vocabulary on {len(D)} descriptors")
    rand_idx = vocab_mod.draw_rand_idx(torch.Generator().manual_seed(args.seed), len(D),
                                       args.branching, args.depth)
    v = vocab_mod.train_vocab(torch.as_tensor(D).to(device), rand_idx,
                              branching=args.branching, depth=args.depth)
    vocab_mod.save_vocab(v, args.out)
    print(f"saved {v.n_words}-word vocabulary to {args.out}")
    return v


if __name__ == "__main__":
    main()
