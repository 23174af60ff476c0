"""prefill_tokens_per_s (host clock): the prompt tokens of every request
the window completed, over the span from its first submit to its last
completion.  The window closes at a completion, so the span holds whole
requests only."""


def read(ctx):
    return sum(r.length for r in ctx.window if r.ok) / ctx.span_s
