"""``mesher_busy_s_per_shape.serve``: the host mesher's own work, the
``mesh.mesher`` spans its worker thread opens around each ``mt_add_blocks``
call, summed over the traced run's untraced rest and divided by the shapes
the rest served, in seconds. Beside ``mesher_s_per_shape.serve``, the main
thread's wait for that work: the difference ran while the device worked.
None where the program records no spans."""

from portbench import program_spans


def read(run):
    return program_spans.seconds_per_shape(run, {"mesh.mesher"})
