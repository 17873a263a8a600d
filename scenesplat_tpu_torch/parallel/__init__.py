"""Data parallel training and scene-sharded evaluation across processes
(counterpart of ``scenesplat_tpu/parallel``): ``dist`` for the process
group, per-process batch rows, the differentiable sum over ranks and the
draws shaped like the batch; ``dist_eval`` for the testers' and evaluator
hooks' scene shards and the merge of their results."""
