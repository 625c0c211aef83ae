"""Kernel launches of the port (gemv.LAUNCHES + kv_cache.LAUNCHES) in an
Engine.step call that admitted nothing, mean over the window: an exact
count."""


def read(run):
    steps = [s for s in run.steps if s.kind == "decode"]
    return sum(s.launches for s in steps) / len(steps) if steps else None
