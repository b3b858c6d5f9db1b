"""``entry_s``: seconds of a decomposition outside the peel (the
graph's ``BipartiteGraph.from_edges``, then ``run()`` less its
``peel``: flags, the θ digest and summary lines), the program's
``graph.from_edges`` and ``run`` spans (``seconds["graph"]`` +
``seconds["run"]`` - ``seconds["peel"]``), the mean over the window's
decompositions.  Nothing to read where the program has no such spans."""


def read(rec):
    ds = rec.get("decomps")
    if not ds or any(k not in d["seconds"] for d in ds
                     for k in ("graph", "run")):
        return None
    return sum(d["seconds"]["graph"] + d["seconds"]["run"]
               - d["seconds"]["peel"] for d in ds) / len(ds)
