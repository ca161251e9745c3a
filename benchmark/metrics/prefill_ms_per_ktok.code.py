"""Host-clock ms of the engine's ``serve.prefill`` spans that started in
the window, per 1000 prompt tokens they prefilled (the span ends at the
first token's fetch)."""


def read(run):
    spans = run.get("prefill_spans") or []
    tokens = sum(n for _, n in spans)
    if run.get("kind") != "serve" or not tokens:
        return None
    return sum(s for s, _ in spans) * 1e3 / (tokens / 1000)
