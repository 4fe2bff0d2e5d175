"""nonkernel_device_ms: device milliseconds per call of every operation
on the engine's stream but the configuration's TEDA kernel (the state
selects, fills, the flag mask, the contract's rows), from the traced
window.  The harness's own summary reduction and copy run on a stream
of their own and are left out."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.calls():
        return None
    name = ctx["load"]("roofline", ctx["config"]["kernel"]).KERNEL
    streams = {s for n, _, _, s in tr.ops if name in n}
    if not streams:
        return None
    ns = sum(b - a for n, a, b, s in tr.ops
             if s in streams and name not in n)
    return ns / 1e6 / tr.calls()
