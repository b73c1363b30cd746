"""Meters, file logging and coloured console output.

A copy of `relativepose_tpu/utils/log.py` (plain Python)."""

from __future__ import annotations

import sys
import time


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class FrequencyAverageMeter:
    """Events-per-second meter."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.start = time.time()
        self.count = 0
        self.rate = 0.0

    def update(self, n=1):
        self.count += n
        dt = time.time() - self.start
        self.rate = self.count / dt if dt > 0 else 0.0


class FileLogger:
    """Append-and-print logger."""

    def __init__(self, log_file):
        self.log_file = log_file

    def __call__(self, msg):
        print(msg)
        with open(self.log_file, "a") as f:
            f.write(str(msg) + "\n")


_COLORS = dict(gray=30, red=31, green=32, yellow=33, blue=34, magenta=35,
               cyan=36, white=37)


def colorize(string, color="green", bold=False, highlight=False):
    attrs = []
    num = _COLORS[color]
    if highlight:
        num += 10
    attrs.append(str(num))
    if bold:
        attrs.append("1")
    return f"\x1b[{';'.join(attrs)}m{string}\x1b[0m"


def colored_log(prompt, texts, color="green", bold=True):
    print(colorize(prompt, color, bold=bold) + texts, file=sys.stderr)


def callback_log(texts):
    colored_log("[Callback] ", texts)



def warning_log(texts):
    colored_log("[Warning] ", texts, color="yellow")


def error_log(texts):
    colored_log("[Error] ", texts, color="red")
    raise RuntimeError(texts)
