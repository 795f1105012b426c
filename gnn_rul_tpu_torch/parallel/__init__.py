"""Training across ranks on ``torch.distributed`` (counterpart of
``gnn_rul_tpu/parallel``): ``multihost`` (joining a job, the backend rule),
``mesh`` (the (data, model) DeviceMesh and the tensor-parallel rule),
``data_axis`` (a batch's rows over the data ranks and the operations that
reach across them), ``model_axis`` (parameters split over the model ranks
and the collectives' autograd rules),
``graph_partition`` (the node-sharded graph engines over the model ranks),
``dp`` (``ShardedTrainer``) and ``_dist_worker`` (one rank of a job)."""
