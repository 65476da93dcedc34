from consensus_clustering_tpu_torch.cli import main

main()
