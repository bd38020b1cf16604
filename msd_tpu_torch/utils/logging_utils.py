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
