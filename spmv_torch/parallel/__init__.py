"""Distribution layer: partitioning, the compiled halo plan and the
distributed matrix, with every shard stacked on one device."""
