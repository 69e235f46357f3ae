"""Logging of the port's command-line surfaces (the reference's
``obs/logging_setup.py`` on the ``repro_torch`` logger tree).

The default rendering is what ``print`` gives, ``%(message)s`` to stdout
at INFO, so output that scripts parse stays byte for byte the same.
``-v`` adds DEBUG records with a timestamped prefix; ``--quiet`` keeps
warnings and errors only. Progress lines go to the
``repro_torch.progress`` logger, which writes to stderr and does not
propagate, so they never mix into a stdout that is piped to a parser.
"""
from __future__ import annotations

import logging
import sys

ROOT = "repro_torch"
_CONFIGURED = False


class _LiveStream:
    """Resolves ``sys.stdout``/``sys.stderr`` when a record is written, so
    redirection (``contextlib.redirect_stdout``, pytest's capture)
    applies to records logged after the handler was made."""

    def __init__(self, name: str):
        self._name = name

    def write(self, s: str) -> None:
        getattr(sys, self._name).write(s)

    def flush(self) -> None:
        stream = getattr(sys, self._name)
        if hasattr(stream, "flush"):
            stream.flush()


def setup(verbosity: int = 0, quiet: bool = False) -> logging.Logger:
    """Configure the ``repro_torch`` logger tree. Idempotent; a later
    call re-applies the level and format."""
    global _CONFIGURED
    root = logging.getLogger(ROOT)
    prog = logging.getLogger(f"{ROOT}.progress")
    if not _CONFIGURED:
        root.addHandler(logging.StreamHandler(_LiveStream("stdout")))
        ph = logging.StreamHandler(_LiveStream("stderr"))
        ph.setFormatter(logging.Formatter("%(message)s"))
        prog.addHandler(ph)
        prog.propagate = False
        root.propagate = False
        _CONFIGURED = True
    handler = root.handlers[0]
    if quiet:
        level, fmt = logging.WARNING, logging.Formatter("%(message)s")
    elif verbosity >= 1:
        level, fmt = logging.DEBUG, logging.Formatter(
            "%(asctime)s %(levelname).1s %(name)s: %(message)s",
            datefmt="%H:%M:%S")
    else:
        level, fmt = logging.INFO, logging.Formatter("%(message)s")
    root.setLevel(level)
    prog.setLevel(level)
    handler.setFormatter(fmt)
    return root


def get_logger(name: str = ROOT) -> logging.Logger:
    """A logger under the ``repro_torch`` tree, configured with the
    defaults on first use."""
    if not _CONFIGURED:
        setup()
    return logging.getLogger(name)


def add_logging_args(parser) -> None:
    """Attach the shared ``-v``/``--quiet`` flags to an argparse parser."""
    parser.add_argument("-v", "--verbose", action="count", default=0,
                        help="verbose logging (repeatable)")
    parser.add_argument("--quiet", action="store_true",
                        help="only warnings and errors")


def setup_from_args(args) -> logging.Logger:
    return setup(verbosity=getattr(args, "verbose", 0),
                 quiet=getattr(args, "quiet", False))


__all__ = ["setup", "get_logger", "add_logging_args", "setup_from_args"]
