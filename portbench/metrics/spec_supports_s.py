"""``spec_supports_s``: seconds of the spec's ⋈init supports a
decomposition (csr: pair butterflies, workloads, vertex or edge counts;
beindex: the edge supports from the index), the program's
``spec.supports`` span (``seconds["spec.supports"]``), the mean over the
window's decompositions.  Nothing to read where the program has no such
span."""


def read(rec):
    ds = rec.get("decomps")
    if not ds or any("spec.supports" not in d["seconds"] for d in ds):
        return None
    return sum(d["seconds"]["spec.supports"] for d in ds) / len(ds)
