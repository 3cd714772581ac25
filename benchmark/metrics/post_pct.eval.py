"""The share of an evaluation epoch's time spent after the generations, by
the harness's clock: ``run_eval``'s ``record['post_ms']`` (the evaluator's
metrics, their aggregation and the meter, each generation's closing sync)
over the epochs' time, over the window. Moves ``points_per_s``.
"""


def read(ctx):
    return ctx.counters.get("post_pct")
