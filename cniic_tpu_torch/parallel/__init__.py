"""Multi-device layer of the port: `mesh` (the process group, lane sharding,
the point-sharded k-means and the sharded MSE) and `launch` (spawning ranks
on one host)."""
