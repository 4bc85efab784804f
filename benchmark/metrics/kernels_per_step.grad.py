"""Device kernels per optimisation step over the traced window (rank
0): the launch count the plain shade's forward and backward inflate."""


def read(data):
    r = data["ranks"][0]
    if not r or not r["units"]:
        return None
    n = sum(count for count, _ in r["kernels"].values())
    return n / r["units"] if n else None
