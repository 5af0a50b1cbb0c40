"""Checks a traffic mix names in its `checks` list: `checks/<name>.py`
defines `numbers(files, truth, config, traffic) -> dict` over the side
files of the clips compared (one dict a clip, as its entry returned them)
and the drawn truth (`harness.make_clip`); each number is held to the
cell's `limits/<cell>.json` like the others.  Nothing here imports the
program."""
