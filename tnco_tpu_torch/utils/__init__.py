"""Host utilities: tensor-network graphs, arrays, the greedy path finder."""
