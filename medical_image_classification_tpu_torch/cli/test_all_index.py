"""The full metric suite of ``cli/test.py --all-index``, with its CSV
(default ``metrics.csv``).

  python -m medical_image_classification_tpu_torch.cli.test_all_index \
      --data-path /data/oct/test --model medmamba --weights model.pt \
      --csv-out metrics.csv [--device cuda]
"""

from __future__ import annotations

import logging

from medical_image_classification_tpu_torch.cli.test import main, parser


def parse_args(argv=None):
    p = parser(__doc__)
    p.add_argument("--csv-out", default="metrics.csv")
    args = p.parse_args(argv)
    args.all_index = True
    return args


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    main(parse_args())
