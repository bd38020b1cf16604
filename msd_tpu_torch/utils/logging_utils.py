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
    that writes nothing (the trainers' Logs.pth keeps every history)."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            logging.warning("no tensorboardX or tensorboard package: no TensorBoard event files are written")
            return _NullWriter()
    return SummaryWriter(log_dir=log_dir)
