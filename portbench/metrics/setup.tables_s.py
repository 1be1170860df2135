"""setup.tables_s (s): the runner's host tables (grid, window tables,
code table, packed table), its set-up lap "tables" (``Stopwatch``)."""

from portbench import stamps

probe = stamps.take


def read(ctx):
    return stamps.setup_s(ctx, "tables")
