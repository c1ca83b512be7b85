"""Training on the frozen tower: steps, loop, sweeps, metrics, logging,
checkpoints and parameter partitioning."""
