"""Sharding of the port: logical-axis partition rules onto a mesh's
DTensor placements (``partition``) and the GPipe schedule across
pipeline stages (``pipeline``)."""
