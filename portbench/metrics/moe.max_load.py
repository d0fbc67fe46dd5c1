"""The experts' load imbalance over the window: the mean, over the
window's dropless MoE calls, of the largest expert's routed rows over the
mean rows an expert (rows x top_k / experts), from the port's routed-row
sums (``models.moe.ROUTE_LOAD``), summed on the device and read once
after the window.  1 is even load; nothing to read without those sums."""


def read(run):
    load = getattr(run, "route_load", None)
    if not load or not load["calls"]:
        return None
    return load["max_share_sum"] / load["calls"]
