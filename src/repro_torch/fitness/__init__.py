"""BBOB fitness functions."""
