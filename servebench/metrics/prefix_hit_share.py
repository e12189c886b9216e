"""Prompt tokens served from the prefix cache (the engine's
``prefix_tokens_saved`` counter, its change over the window) over the prompt
tokens of the requests admitted in the window, in %."""


def read(run):
    return run.saved_tokens / run.prompt_tokens * 100.0 if run.prompt_tokens else None
