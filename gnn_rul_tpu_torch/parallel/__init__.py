"""Training across ranks on ``torch.distributed`` (counterpart of
``gnn_rul_tpu/parallel``): ``multihost`` (joining a job, the backend rule),
``mesh`` (the (data, model) DeviceMesh), ``data_axis`` (a batch's rows over
the data ranks and the operations that reach across them),
``graph_partition`` (the node-sharded graph engines over the model ranks),
``dp`` (``ShardedTrainer``) and ``_dist_worker`` (one rank of a job)."""
