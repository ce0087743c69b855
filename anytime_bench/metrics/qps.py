"""qps: queries answered within the window, per second of the window."""

import numpy as np


def read(ctx):
    win = ctx.window
    return float(np.sum(win.done < win.seconds)) / win.seconds
