"""Logging: colored stderr sink + plain file sink with elapsed wall-time.

Mirrors the spirit of the reference's loguru setup (reference
vamb/__main__.py:54-61, 702-715): timestamps + elapsed seconds on stderr,
full log mirrored to `<outdir>/log.txt`.
"""

import logging
import time
from pathlib import Path

logger = logging.getLogger("vamb_torch")
_START = time.time()


class _ElapsedFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        elapsed = time.time() - _START
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        return f"{stamp} | {elapsed:>9.2f}s | {record.getMessage()}"


def setup_logging(outdir: Path | None = None, level: int = logging.INFO) -> None:
    logger.setLevel(level)
    logger.handlers.clear()
    stderr_handler = logging.StreamHandler()
    stderr_handler.setFormatter(_ElapsedFormatter())
    logger.addHandler(stderr_handler)
    if outdir is not None:
        file_handler = logging.FileHandler(outdir / "log.txt")
        file_handler.setFormatter(_ElapsedFormatter())
        logger.addHandler(file_handler)
