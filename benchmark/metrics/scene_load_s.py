"""Seconds of host scene code in set-up: the scene's load, its BVH and
tile pack (``render.load_scene`` + ``ensure_accel``; on several ranks
``parallel.dist.prepare_scene`` builds each rank's shard), timed by the
benchmark's host clock around those calls; the slowest rank's."""


def read(data):
    vals = [r["scene_load_s"] for r in data["ranks"]
            if r and r.get("scene_load_s") is not None]
    return max(vals) if vals else None
