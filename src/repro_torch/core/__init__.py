"""Core CMA-ES, the PRNG and the IPOP ladder."""
