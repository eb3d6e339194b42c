"""Model families: how a configuration's reference and the program's model
are built, fed and read (``benchmark/configs/<config>.json``, key
``family``)."""
