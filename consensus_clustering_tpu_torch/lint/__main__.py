# Copied from consensus_clustering_tpu/lint/__main__.py.
import sys

from consensus_clustering_tpu_torch.lint.runner import main

sys.exit(main())
