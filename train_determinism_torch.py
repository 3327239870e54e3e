#!/usr/bin/env python3
"""The trainer's train_step with cuDNN's defaults against its deterministic
algorithms, on the card.

models/train.py trains with cuDNN's defaults (nondeterministic f32 weight
gradients, no autotuner), so two runs from one seed end with other
weights.  This script times train_step (on the card one CUDA graph a step:
forward, backward and update) at batch 512 (train_asdnet_torch.py's
default) in windows of 60 steps, the two settings in turns (defaults,
deterministic, deterministic, defaults), each window from the same seeded
model, batch and draws after three warm steps, after one untimed run of
each setting; each run's trained weights are compared bit for bit with its
setting's first.  Prints a line a window, then one JSON line
``{"metric": "train_steps_per_s", ...}`` with the card's name and power
limit; exits non-zero if the deterministic runs trained other weights.

    python train_determinism_torch.py       # on the card
"""

import json
import time

BATCH, STEPS = 512, 60
ORDER = ("default", "deterministic", "deterministic", "default")


def run(setting, device):
    """(steps/s over STEPS train_steps, the trained weights' bytes) with
    cuDNN at ``setting``, from the seeded model, batch and draws."""
    import torch
    from asdslam_torch.models import asdnet
    from asdslam_torch.models import train as T

    model = asdnet.ASDNetTrain(asdnet.init_params(
        asdnet.draw_init_seeds(torch.Generator().manual_seed(0)))).to(device)
    g = torch.Generator(device).manual_seed(0)
    a, p = T.make_batch(T.draw_batch(g, BATCH))
    lr = torch.tensor(0.1, device=device)
    flags = torch.backends.cudnn
    saved = flags.deterministic, flags.benchmark
    flags.deterministic, flags.benchmark = setting == "deterministic", False
    try:
        for _ in range(3):
            T.train_step(model, a, p, lr, T.draw_step(g, BATCH))
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(STEPS):
            T.train_step(model, a, p, lr, T.draw_step(g, BATCH))
        torch.cuda.synchronize(device)
        rate = STEPS / (time.perf_counter() - t0)
    finally:
        flags.deterministic, flags.benchmark = saved
    return rate, b"".join(w.detach().cpu().numpy().tobytes() for w in model.conv)


def main():
    from asdslam_torch.system import device_names, require_device

    device = require_device("cuda")
    name, card = device_names(device)
    print(f"card: {card}", flush=True)
    first = {s: run(s, device)[1] for s in ("default", "deterministic")}
    rates = {}
    for setting in ORDER:
        rate, weights = run(setting, device)
        same = weights == first[setting]
        rates.setdefault(setting, []).append(dict(steps_per_s=rate, same_weights=same))
        print(f"{setting:14s} {rate:8.3f} steps/s, weights "
              + ("bitwise" if same else "not") + " those of its first run", flush=True)
    out = {"metric": "train_steps_per_s", "device": name, "card": card, "batch": BATCH,
           "steps": STEPS, "rates": rates}
    print(json.dumps(out), flush=True)
    if not all(r["same_weights"] for r in rates["deterministic"]):
        raise SystemExit("cuDNN's deterministic algorithms trained other weights")
    return out


if __name__ == "__main__":
    main()
