"""Multi-device training over `torch.distributed`, the counterpart of
`cvaegan_tpu/parallel/`: `mesh` (the ('data', 'model') grid, the active
mesh and the data-parallel row layout) and `distributed` (joining the
process group)."""
