"""The campaign mesh engine and its member sharding."""
