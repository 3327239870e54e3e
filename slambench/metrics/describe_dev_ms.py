"""Mean ms of device time a committed step from the patches cut to the
descriptors masked: ASDNet on every feature slot (the ``Tracer`` span
``device/step/describe``, from the step's stage clock)."""


def read(run):
    s = run["spans"].get("device/step/describe")
    return s["total_s"] / s["count"] * 1e3 if s and s["count"] else None
