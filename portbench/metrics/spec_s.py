"""``spec_s``: seconds of the spec build a decomposition (host wedge or
BE-Index build, packing, uploads): ``run()``'s ``seconds["peel"]`` less
the CD and FD phases, the mean over the window's decompositions."""


def read(rec):
    ds = rec.get("decomps")
    if not ds:
        return None
    return sum(d["seconds"]["peel"] - d["seconds"]["cd"]
               - d["seconds"]["fd"] for d in ds) / len(ds)
