"""Run one cell of the mfmg_torch benchmark once, on the card it starts on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells, their configurations, traffic and metrics are in BENCHMARK.json
at the root of the checkout.  Without a CUDA device the run fails; ``--dry``
rehearses the run on the CPU at the configuration's small size.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
