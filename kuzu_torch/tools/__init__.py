"""Evaluation of trained run dirs."""
