"""Desktop GUI application (the reference's gan_login_gui.py): login, the
four processing tabs and their model manager (port of the JAX package's
``gui``)."""
