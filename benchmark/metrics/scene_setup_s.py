"""Host seconds of the scene's parse, cluster build and copy to the card
in set-up (``load_any_scene`` and ``to_device``, ended by a
synchronise)."""


def read(ctx):
    return ctx.scene_setup_s
