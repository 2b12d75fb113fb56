"""Eval step and validate; the training steps are not ported yet."""
