"""Pixel chunks per optimisation step over the traced window (rank 0):
the window's change of ``ptx_torch.diff.inverse.STATS.chunks`` over its
steps, each chunk one forward and backward of the device scan (32 a step
at 256x256 x 16 spp under ``render.MAX_RAYS_PER_LAUNCH`` = 32,768 rays)."""


def read(data):
    r = data["ranks"][0]
    c = (r or {}).get("counters") or {}
    if not r or not r.get("units") or not c.get("chunks"):
        return None
    return c["chunks"] / r["units"]
