"""Output tokens returned inside the window, of finished and unfinished
requests alike, over the window's length."""
import harness


def read(run):
    w = harness.window_s(run)
    return harness.tokens_in_window(run) / w if w > 0 else None
