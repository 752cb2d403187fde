"""Console + file logger and the CLIs' boolean flags.

The port's copy of ``uemda_tpu/utils/log.py`` (reference
``uemda/utils/tools.py:221-237,33-46``): a logger that writes to the
console and to ``<logdir>/<time>.log``, the arguments logged one a line,
and ``str2bool`` for ``--flag 0|1`` options.
"""

import logging
import os
import time


def get_console_file_logger(name: str, logdir: str, level=logging.INFO):
    os.makedirs(logdir, exist_ok=True)
    logger = logging.Logger(name)
    logger.setLevel(level)
    fmt = logging.Formatter(
        "%(asctime)s, %(levelname)s:%(name)s:%(message)s", "%Y-%m-%d %H:%M:%S"
    )
    ch = logging.StreamHandler()
    ch.setFormatter(fmt)
    logger.addHandler(ch)
    fh = logging.FileHandler(os.path.join(logdir, f"{time.time()}.log"))
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    return logger


def logging_args(args, logger):
    logger.info(">>>>> arguments:")
    for k, v in vars(args).items():
        logger.info(f"  {k}={v}")


def str2bool(v: str) -> bool:
    if str(v).lower() in ("yes", "true", "t", "y", "1"):
        return True
    if str(v).lower() in ("no", "false", "f", "n", "0"):
        return False
    raise ValueError(f"unsupported boolean value: {v}")
