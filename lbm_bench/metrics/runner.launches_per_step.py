"""runner.launches_per_step: kernel launches over the window, by the
program's own counters (every entry point and instance), per step."""


def read(ctx):
    if not ctx["steps"]:
        return None
    return ctx["launches"] / ctx["steps"]
