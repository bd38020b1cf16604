"""``mesh_tail_s_per_shape.serve``: the host's work after a streamed mesh's
last slab, with nothing queued on the device: the ``mesh.finish`` spans
(the mesher's finish view and the vertex and face copies) and the
``mesh.ply`` spans (the PLY's write), summed over the traced run's untraced
rest and divided by the shapes the rest served, in seconds. None where the
program records no spans."""

from portbench import program_spans


def read(run):
    return program_spans.seconds_per_shape(run, {"mesh.finish", "mesh.ply"})
