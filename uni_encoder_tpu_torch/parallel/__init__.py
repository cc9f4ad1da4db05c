"""Data-parallel training and sharded evaluation over torch.distributed
(`mesh`: the process group and the collectives; `launch`: the ranks of one
command)."""
