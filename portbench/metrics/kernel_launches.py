"""``kernel_launches``: launches of the port's hand-written kernels a
decomposition (``kernels.ops.launch_counts()`` summed over kernels), the
mean over the window's decompositions."""


def read(rec):
    ds = rec.get("decomps")
    if not ds:
        return None
    return sum(d["launches"] for d in ds) / len(ds)
