"""The LM serving engine."""
