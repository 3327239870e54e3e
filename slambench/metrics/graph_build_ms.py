"""ms a frame of CUDA-graph builds in the window: the total of the
``Tracer`` spans ``.../warm-up:<site>`` and ``.../capture:<site>`` that
``utils/graphs.py`` records under the span that paid for them, each build
counted once (a build nested inside another is part of it), over the
window's frames.  A program that records the step's stage clock
(``device/step``) also records its builds, so there a window without a
build reads 0; a program without either records nothing to read."""

BUILDS = ("warm-up:", "capture:")


def read(run):
    spans = run["spans"]
    if not run["frames"] or "device/step" not in spans:
        return None
    total = 0.0
    for name, s in spans.items():
        parts = name.split("/")
        if parts[-1].startswith(BUILDS) and not any(p.startswith(BUILDS) for p in parts[:-1]):
            total += s["total_s"]
    return total / run["frames"] * 1e3
