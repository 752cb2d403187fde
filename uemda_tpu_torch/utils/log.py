"""Console + file logger, the CLIs' boolean flags and run trackers.

The port's copy of ``uemda_tpu/utils/log.py`` (reference
``uemda/utils/tools.py:221-237,33-46,419-452``): a logger that writes to
the console and to ``<logdir>/<time>.log``, the arguments logged one a
line, ``str2bool`` for ``--flag 0|1`` options, a running average and a
best-value tracker.
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


class AverageMeter:
    """The last value, sum, count and running average of a series
    (``tools.py:432-452``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = self.avg = self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def str2bool(v: str) -> bool:
    if str(v).lower() in ("yes", "true", "t", "y", "1"):
        return True
    if str(v).lower() in ("no", "false", "f", "n", "0"):
        return False
    raise ValueError(f"unsupported boolean value: {v}")


class BestLog:
    """The best value of a series, its iteration and a log line
    (``tools.py:419-429``); ``high``: larger is better. A tie replaces the
    best, as in the reference."""

    def __init__(self, high: bool = True):
        self.high = high
        self.value = -999999.0 if high else 999999.0
        self.iter = 0
        self.log_str = ""

    def update(self, val, it, log_str=""):
        cond = (val >= self.value) if self.high else (val <= self.value)
        if cond:
            self.value = val
            self.iter = it
            self.log_str = log_str
        return cond
