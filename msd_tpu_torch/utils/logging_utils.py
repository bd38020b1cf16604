"""Logging configuration matching the reference CLI conventions
(ref: deep_sdf/utils.py:42-83)."""

from __future__ import annotations

import logging


def add_common_args(arg_parser):
    arg_parser.add_argument(
        "--debug",
        dest="debug",
        default=False,
        action="store_true",
        help="If set, debugging messages will be printed",
    )
    arg_parser.add_argument(
        "--quiet",
        "-q",
        dest="quiet",
        default=False,
        action="store_true",
        help="If set, only warnings will be printed",
    )
    arg_parser.add_argument(
        "--log",
        dest="logfile",
        default=None,
        help="If set, the log will be saved using the specified filename.",
    )


def configure_logging(args=None, logfile: str | None = None):
    logger = logging.getLogger()
    if args is not None and getattr(args, "debug", False):
        logger.setLevel(logging.DEBUG)
    elif args is not None and getattr(args, "quiet", False):
        logger.setLevel(logging.WARNING)
    else:
        logger.setLevel(logging.INFO)
    formatter = logging.Formatter("MsdTpu - %(levelname)s - %(message)s")
    for h in list(logger.handlers):
        logger.removeHandler(h)
    handler = logging.StreamHandler()
    handler.setFormatter(formatter)
    logger.addHandler(handler)
    logfile = logfile or (getattr(args, "logfile", None) if args is not None else None)
    if logfile is not None:
        fh = logging.FileHandler(logfile)
        fh.setFormatter(formatter)
        logger.addHandler(fh)


class _NullWriter:
    """Stands in for a TensorBoard writer when no writer package imports."""

    def add_scalar(self, *args, **kwargs):
        pass

    def add_hparams(self, *args, **kwargs):
        pass

    def add_figure(self, *args, **kwargs):
        pass

    def flush(self):
        pass

    def close(self):
        pass


def open_summary_writer(log_dir: str):
    """A TensorBoard writer on ``log_dir`` (tensorboardX, else
    torch.utils.tensorboard), imported here; without either, a stand-in
    that writes nothing (the trainers' Logs.pth keeps every history).

    The writer's event files are closed at process exit before
    multiprocessing's own exit finalizers run, or when the writer is
    collected. tensorboardX closes them from ``atexit``, which in a spawned
    process (a rank of ``run_ranks``) comes after those finalizers have
    closed the event queue; its logger thread then dies with events unread,
    and closing puts a stop event into the full queue and waits for room
    forever, so the rank never exits. The finalizer holds the writer's dict
    of event files, not the writer, so a writer closed and dropped (a
    search trial's) leaves nothing behind."""
    import multiprocessing.util

    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            logging.warning("no tensorboardX or tensorboard package: no TensorBoard event files are written")
            return _NullWriter()
    writer = SummaryWriter(log_dir=log_dir)
    # above the event queue's own finalizer (exit priority 10); closing a file twice is a no-op
    multiprocessing.util.Finalize(writer, _close_files, args=(writer.all_writers,), exitpriority=100)
    return writer


def _close_files(files):
    for f in list(files.values()):
        f.close()
