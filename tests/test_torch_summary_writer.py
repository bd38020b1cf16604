"""The port's TensorBoard writer (``open_summary_writer``) in a spawned
process, as the main rank of ``run_ranks`` opens it in a trainer: the
process exits, with every event written, though nothing closed the writer.
tensorboardX closes it from ``atexit``, which in a spawned process runs
after multiprocessing has closed the writer's event queue; that close then
waited forever for room in the queue (the rank hung at exit). This module
imports no JAX: the spawned process imports it again."""

import gc
import multiprocessing
import struct
import weakref

import pytest

from msd_tpu_torch.utils.logging_utils import open_summary_writer

pytest.importorskip("tensorboardX")

# more events than tensorboardX's event queue holds (10)
EVENTS = 15


def write_scalars(log_dir):
    """Write EVENTS scalars and return without closing the writer. Its
    logger thread is slowed (0.1 s an event), as on a loaded host, so the
    queue is full when the process exits."""
    import time

    import tensorboardX.event_file_writer as efw

    write_event = efw.EventsWriter.write_event

    def slow(self, event):
        time.sleep(0.1)
        return write_event(self, event)

    efw.EventsWriter.write_event = slow
    w = open_summary_writer(log_dir)
    for i in range(EVENTS):
        w.add_scalar(f"x{i}", float(i), 1)


def records(path):
    """The records of a TFRecord file: 8-byte length, 4-byte CRC, data,
    4-byte CRC."""
    data, out, off = path.read_bytes(), [], 0
    while off < len(data):
        (n,) = struct.unpack("<Q", data[off:off + 8])
        out.append(data[off + 12:off + 12 + n])
        off += 16 + n
    return out


def test_spawned_process_exits_with_its_events_written(tmp_path):
    from tensorboardX.proto import event_pb2

    p = multiprocessing.get_context("spawn").Process(target=write_scalars, args=(str(tmp_path),))
    p.start()
    p.join(120)
    alive = p.is_alive()
    if alive:
        p.kill()
        p.join()
    assert not alive, "the process that wrote the events did not exit within 120 s"
    assert p.exitcode == 0
    files = sorted(tmp_path.glob("events.out.tfevents.*"))
    assert len(files) == 1, f"event files: {files}"
    tags = [v.tag for r in records(files[0]) for v in event_pb2.Event.FromString(r).summary.value]
    assert tags == [f"x{i}" for i in range(EVENTS)]


def test_closed_writer_is_not_kept_alive(tmp_path):
    """A writer closed and dropped is collected: the exit finalizer holds
    its event files, not the writer."""
    w = open_summary_writer(str(tmp_path))
    w.add_scalar("x", 1.0, 1)
    w.close()
    ref = weakref.ref(w)
    del w
    gc.collect()
    assert ref() is None
    assert len(list(tmp_path.glob("events.out.tfevents.*"))) == 1
