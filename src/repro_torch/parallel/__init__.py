"""Multi-device parallelism of the port: the logical-axis sharding rules
as DTensor placements (``sharding``) and the GPipe pipeline over a
``pipe`` mesh axis (``pipeline``)."""
