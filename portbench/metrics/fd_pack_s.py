"""``fd_pack_s``: seconds the FD drivers spend preparing their
partition arrays on the host and copying them to the device, a
decomposition (the fused stack pack, the BE-Index sub-indices), the
program's ``fd.pack`` spans (``seconds["fd.pack"]``, summed over a
decomposition's dispatches), the mean over the window's decompositions.
Nothing to read where the program has no such span."""


def read(rec):
    ds = rec.get("decomps")
    if not ds or any("fd.pack" not in d["seconds"] for d in ds):
        return None
    return sum(d["seconds"]["fd.pack"] for d in ds) / len(ds)
