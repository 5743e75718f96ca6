"""Train, prefill and decode steps of the LM scaffold."""
