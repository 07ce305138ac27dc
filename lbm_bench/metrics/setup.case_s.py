"""setup.case_s: seconds of the harness's span around the set-up's call
into the program's case layer (see BENCHMARK.json and PERF.md)."""


def read(ctx):
    return ctx["spans"].get("setup.case_s")
