"""Client-stacked data plane primitives (diffusion hops, STC hops)."""
