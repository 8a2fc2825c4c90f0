"""Checkpoints, metric summaries and epoch artifacts, the weight bridge
between flax trees and state_dicts, FLOP accounting and GPU timing."""
