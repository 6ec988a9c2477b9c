"""Layer device: the mean a run of the seconds outside every layer span of
the port (``app.*``, ``check.static``, ``fit.*``) in which no kernel, copy
or fill ran on the card, in a traced window (``benchmark/spans.py``). With
the layers' ``idle_*_s.run`` it adds up to the window's idle seconds over
its runs."""

from benchmark import spans


def read(ctx):
    return spans.per_run(ctx, spans.idle_outside_seconds)
