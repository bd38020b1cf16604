"""``mesh_s_per_shape.serve``: the host clock around each ``create_mesh``
call and the latent's save, summed over the window and divided by the
shapes served, in seconds."""


def read(run):
    r = run.readings
    if not r.get("shapes"):
        return None
    return r["mesh_s"] / r["shapes"]
