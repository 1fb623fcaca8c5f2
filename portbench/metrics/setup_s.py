"""setup_s: seconds from process start to the first timed unit: inputs
made, the program built and every shape of the cell warmed (host
clock)."""


def read(ctx):
    return ctx["setup_s"]
