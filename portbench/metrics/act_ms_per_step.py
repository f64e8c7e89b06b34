"""The policy's forward per env step, in ms: the stream's time between the
CUDA events that the policy entry records before and after
``tanh(mean_fn(obs))`` (entries/policy_step.py), the mean over the
``span_steps`` steps timed after the window. None where nothing was timed."""


def read(r):
    spans = getattr(r, "act_ms", None)
    if not spans:
        return None
    return sum(spans) / len(spans)
