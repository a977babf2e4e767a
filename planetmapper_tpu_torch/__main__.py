"""Enable ``python -m planetmapper_tpu_torch`` to run the CLI."""

from . import cli

cli.main()
