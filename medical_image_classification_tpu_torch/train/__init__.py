"""Train and eval steps (eval only so far)."""
