"""Reporting layer of the port (counterpart of ``anovos_tpu/data_report``):
``save_stats`` writes ``<master_path>/<function_name>.csv``, the chart
builders one plotly-schema JSON per chart per column plus
``data_type.csv``, and ``anovos_report`` renders them as one
self-contained ``ml_anovos_report.html``."""
