"""``fit_s_per_shape.serve``: the host clock around each batch's
``reconstruct_batch``, which ends in a fetch of its losses, summed over the
window and divided by the shapes served, in seconds."""


def read(run):
    r = run.readings
    if not r.get("shapes"):
        return None
    return r["fit_s"] / r["shapes"]
