#!/usr/bin/env python3
"""Train ASDNet with the PyTorch/CUDA port and write weights both packages read.

The twin of train_asdnet.py over asdslam_torch, with its flags plus
``--device {cuda,cpu}`` (cuda unless asked; no card means exit 1, never a
fallback).  Reference protocol (ASDNet/ASDNet/ASDNet.py): the adaptive-scale
log-sigmoid loss for the first half of the steps, then the plain triplet
margin; in-batch hardest-negative mining with anchor swap; the correlation
penalty and global orthogonal regularization; flip / rot90 /
random-resized-crop augmentation; FPR@95 on held-out pairs.

Training data: PhotoTour where a local copy exists (--phototour), a pair
cache (--pairs_cache, written on first use), else matched patch pairs from
the KITTI proxy world (models/proxy_pairs.py), which needs the KITTI ground
truth under the repository's reference/.

Outputs: the weights pickle in the reference's layout (``--asdnet_weights``
of run_slam_torch.py and of run_slam.py) and one JSON line: FPR@95 of the
trained ASDNet against a random one and the classical patch descriptor on
the same held-out pairs, the training's steps/s, and the card's name and
power limit.

Usage:
  python train_asdnet_torch.py --steps 2000 --out asdnet_weights.pkl
  python train_asdnet_torch.py --pairs_cache pairs.npz --steps 300 --device cpu
"""

import argparse
import json
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--pool", type=int, default=40000, help="pre-generated pair pool size")
    p.add_argument("--eval_pairs", type=int, default=4000)
    p.add_argument("--seq", default="00",
                   help="proxy sequence(s), comma-separated: batches are drawn "
                        "within one sequence at a time, round-robin")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--base_lr", type=float, default=0.5)
    p.add_argument("--phototour", default="", help="local PhotoTour dir")
    p.add_argument("--pairs_cache", default="",
                   help="npz path: cache/reuse the generated pair pools")
    p.add_argument("--out", default="asdnet_weights.pkl")
    p.add_argument("--report", default="")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def proxy_pools(args, device):
    """Pools from the KITTI proxy: (pool_a, pool_p, eval_a, eval_p,
    seq_bounds), each sequence's pairs one slice of the pool."""
    from asdslam_torch.models.proxy_pairs import ProxyPairSource

    seqs = [q.strip() for q in args.seq.split(",") if q.strip()]
    t0 = time.time()
    per = -(-args.pool // len(seqs))
    pools = []
    for q in seqs:
        pools.append(ProxyPairSource(q, scale=args.scale, device=device).sample(per))
        print(f"  seq {q}: {per} pairs ({time.time() - t0:.0f}s)", flush=True)
    pool_a = np.concatenate([a for a, _ in pools])[:args.pool]
    pool_p = np.concatenate([b for _, b in pools])[:args.pool]
    # batches are drawn within one sequence so that the hardest-negative
    # mining stays in-domain (cross-world negatives are trivially separable)
    seq_bounds, off = [], 0
    for a, _ in pools:
        n_here = min(len(a), args.pool - off)
        if n_here > 0:
            seq_bounds.append((off, off + n_here))
        off += n_here
    # held-out pairs from a different sampling stream (all sequences)
    per_e = -(-args.eval_pairs // len(seqs))
    evals = [ProxyPairSource(q, scale=args.scale, seed=99, device=device).sample(per_e)
             for q in seqs]
    eval_a = np.concatenate([a for a, _ in evals])[:args.eval_pairs]
    eval_p = np.concatenate([b for _, b in evals])[:args.eval_pairs]
    print(f"pair generation: {time.time() - t0:.0f}s", flush=True)
    return pool_a, pool_p, eval_a, eval_p, seq_bounds


def main(argv=None):
    args = parse_args(argv)

    import torch
    from asdslam_torch.models import asdnet, patch_descriptor, train as T
    from asdslam_torch.system import device_names, require_device

    device = require_device(args.device)
    seq_bounds = None
    if args.phototour:
        patches, ids = T.load_phototour(args.phototour)
        g = torch.Generator().manual_seed(0)
        pool_a, pool_p = T.phototour_batch(patches, ids, T.draw_phototour(g, ids, args.pool))
        eval_a, eval_p = T.phototour_batch(patches, ids,
                                           T.draw_phototour(g, ids, args.eval_pairs))
    elif args.pairs_cache and os.path.exists(args.pairs_cache):
        z = np.load(args.pairs_cache)
        pool_a, pool_p = z["pool_a"], z["pool_p"]
        eval_a, eval_p = z["eval_a"], z["eval_p"]
        if "seq_bounds" in z:
            seq_bounds = [tuple(b) for b in z["seq_bounds"]]
        print(f"loaded {len(pool_a)} cached pairs from {args.pairs_cache}", flush=True)
    else:
        pool_a, pool_p, eval_a, eval_p, seq_bounds = proxy_pools(args, device)
        if args.pairs_cache:
            np.savez_compressed(args.pairs_cache, pool_a=pool_a, pool_p=pool_p,
                                eval_a=eval_a, eval_p=eval_p, seq_bounds=np.asarray(seq_bounds))
    seq_bounds = seq_bounds or [(0, len(pool_a))]

    model = asdnet.ASDNetTrain(asdnet.init_params(
        asdnet.draw_init_seeds(torch.Generator().manual_seed(0)))).to(device)
    gen = torch.Generator(device).manual_seed(1)
    rng = np.random.default_rng(0)
    pool_a_dev = torch.as_tensor(pool_a).to(device)
    pool_p_dev = torch.as_tensor(pool_p).to(device)
    lrs = T.lr_table(args.steps, args.base_lr, device)
    adaptive_until = args.steps // 2
    loss = torch.zeros(())
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    for step in range(args.steps):
        lo, hi = seq_bounds[step % len(seq_bounds)]
        sel = torch.as_tensor(rng.integers(lo, hi, args.batch)).to(device)
        loss = T.train_step(model, pool_a_dev[sel], pool_p_dev[sel], lrs[step],
                            T.draw_step(gen, args.batch), adaptive=step < adaptive_until)
        if step % 200 == 0:
            print(f"step {step}/{args.steps} loss {float(loss):.4f} "
                  f"{(step + 1) / (time.time() - t0):.1f} steps/s", flush=True)
    final_loss = float(loss)  # waits for the last step
    steps_per_s = args.steps / (time.time() - t0)

    # ---- FPR@95 eval: trained ASD vs random ASD vs classical patch desc
    def eval_desc(fn):
        pos, neg = [], []
        B = 1024
        with torch.no_grad():
            for i in range(0, len(eval_a), B):
                da = fn(torch.as_tensor(eval_a[i:i + B]).to(device)).cpu().numpy()
                dp = fn(torch.as_tensor(eval_p[i:i + B]).to(device)).cpu().numpy()
                pos.append(np.linalg.norm(da - dp, axis=1))
                neg.append(np.linalg.norm(da - np.roll(dp, 1, axis=0), axis=1))
        return T.fpr95(np.concatenate(pos), np.concatenate(neg))

    def inference(train_model):
        net = asdnet.ASDNet().to(device)
        net.load_state_dict(train_model.inference_state())
        return net

    rand_model = asdnet.ASDNetTrain(asdnet.init_params(
        asdnet.draw_init_seeds(torch.Generator().manual_seed(7))))
    device_name, card = device_names(device)
    res = {
        "fpr95_asd_trained": round(eval_desc(inference(model)), 4),
        "fpr95_asd_random": round(eval_desc(inference(rand_model)), 4),
        "fpr95_patch_classical": round(eval_desc(patch_descriptor.apply), 4),
        "steps": args.steps, "batch": args.batch,
        "train_pairs": len(pool_a), "eval_pairs": len(eval_a),
        "source": args.phototour or f"kitti_proxy_{args.seq}",
        "base_lr": args.base_lr,
        "train_s": round(time.time() - t0, 1),
        "steps_per_s": round(steps_per_s, 2), "final_loss": final_loss,
        "device": device_name, "card": card,
    }
    print(json.dumps(res), flush=True)
    model.save_weights(args.out)
    print(f"saved weights to {args.out}")
    if args.report:
        with open(args.report, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
