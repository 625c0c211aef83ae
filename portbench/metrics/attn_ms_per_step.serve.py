"""Device ms of the decode-attention kernels (kernels/decode_attention.json) a
step, over the profiled part of the window: every Engine.step runs one
decode."""


def read(run):
    steps = run.traced()
    if run.trace is None or not steps:
        return None
    t = run.family_seconds("decode_attention")
    return t * 1e3 / len(steps) if t > 0 else None
