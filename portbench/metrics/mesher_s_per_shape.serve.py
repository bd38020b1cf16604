"""``mesher_s_per_shape.serve``: the host mesher's seconds as ``create_mesh``
reports them (``mesh.LAST_STREAMING_STATS["t_mesher"]``), summed over the
window and divided by the shapes served, in seconds."""


def read(run):
    r = run.readings
    if not r.get("shapes"):
        return None
    return r["mesher_s"] / r["shapes"]
