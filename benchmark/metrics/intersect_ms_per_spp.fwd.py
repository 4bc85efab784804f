"""Device milliseconds per sample in the intersection kernels over the
traced window (rank 0): the tile plan, the closest and any sweeps, the
small sweeps and the BVH walk, classed by the names below, so that a
change of intersector keeps the metric alive."""

from benchmark.readers import kernel_seconds

KERNELS = ("tile_plan_kernel", "closest_sweep_kernel", "any_sweep_kernel",
           "small_sweep_kernel", "bvh_walk_kernel")


def read(data):
    r = data["ranks"][0]
    seconds = kernel_seconds(r, KERNELS)
    if not r or not r["units"] or not seconds:
        return None
    return 1e3 * seconds / r["units"]
