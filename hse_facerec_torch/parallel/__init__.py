"""Multi-device execution: a mesh of torch devices driven from one process
(``sharding``), the gallery-sharded 1-NN (``knn``), the sharded trainers
(``train_step``) and the multi-device dry run (``dryrun``)."""
