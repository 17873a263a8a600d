"""Data, tensor and context parallel training and scene-sharded
evaluation across processes (counterpart of ``scenesplat_tpu/parallel``):
``dist`` for the process group, the (data, seq, model) layout and its
groups, per-process batch rows, the differentiable sum over ranks and the
draws shaped like the batch; ``tp`` for PT-v3m1's blocks cut over the model
axis; ``context`` for each row's points over the seq axis; ``dist_eval``
for the testers' and evaluator hooks' scene shards and the merge of their
results."""
