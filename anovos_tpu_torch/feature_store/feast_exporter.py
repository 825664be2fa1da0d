"""Feast repository code generation (counterpart of
``anovos_tpu/feature_store/feast_exporter.py``).

Writes a Feast feature-repository file (``anovos.py``): the file source,
entity, feature view and optional feature service of the final written
dataset, built directly as Python source strings, byte for byte the JAX
package's.  black and isort format the text where both are importable.
"""

from __future__ import annotations

import os
from datetime import datetime
from typing import List, Tuple

import numpy as np

from anovos_tpu_torch.shared.table import Table, host_to_column

ANOVOS_SOURCE = "anovos_source"

dataframe_to_feast_type_mapping = {
    "string": "String",
    "int": "Int64",
    "bigint": "Int64",
    "float": "Float32",
    "double": "Float64",
    "timestamp": "String",
    "boolean": "Int64",
}

_PREFIX = '''\
from datetime import timedelta

import pandas as pd
from feast import (
    Entity,
    FeatureService,
    FeatureView,
    Field,
    FileSource,
    PushSource,
    RequestSource,
    ValueType,
)
from feast.on_demand_feature_view import on_demand_feature_view
from feast.types import Float32, Float64, Int64, String
'''


def check_feast_configuration(feast_config: dict, repartition_count: int) -> None:
    """Feast needs exactly one part file, and the four config sections."""
    if repartition_count != 1:
        raise ValueError("Please, set repartition parameter to 1 in write_main block in your config yml!")
    for key, msg in [
        ("file_path", "a path to the anovos feature_store repository"),
        ("entity", "an entity definition"),
        ("file_source", "a file source definition"),
        ("feature_view", "a feature view definition"),
    ]:
        if key not in feast_config:
            raise ValueError(f"Please, provide {msg} in your config yml!")


def generate_entity_definition(config: dict) -> str:
    name = config["name"]
    return (
        f"{name} = Entity(\n"
        f'    name="{name}",\n'
        f'    join_keys=["{config["id_col"]}"],\n'
        f"    value_type=ValueType.STRING,\n"
        f'    description="{config["description"]}",\n'
        f")\n"
    )


def generate_prefix() -> str:
    """Import block of the generated repo file."""
    return _PREFIX


def generate_field(field_name: str, field_type: str) -> str:
    """One schema line; ``field_type`` is already a Feast type."""
    return f'        Field(name="{field_name}", dtype={field_type}),\n'


def generate_fields(types: List[Tuple[str, str]], exclude_list: List[str]) -> str:
    out = ""
    for field_name, field_type in types:
        if field_name not in exclude_list:
            out += generate_field(field_name, dataframe_to_feast_type_mapping.get(field_type, "String"))
    return out


def generate_feature_view(types, exclude_list, config: dict, entity_name: str) -> str:
    return (
        f"{config['name']} = FeatureView(\n"
        f'    name="{config["name"]}",\n'
        f'    entities=["{entity_name}"],\n'
        f"    ttl=timedelta(seconds={config['ttl_in_seconds']}),\n"
        f"    schema=[\n{generate_fields(types, exclude_list)}    ],\n"
        f"    online=True,\n"
        f"    source={ANOVOS_SOURCE},\n"
        f'    tags={{"production": "True"}},\n'
        f'    owner="{config["owner"]}",\n'
        f")\n"
    )


def generate_file_source(config: dict, file_name: str = "Test") -> str:
    return (
        f"{ANOVOS_SOURCE} = FileSource(\n"
        f'    path="{file_name}",\n'
        f'    timestamp_field="{config["timestamp_col"]}",\n'
        f'    created_timestamp_column="{config["create_timestamp_col"]}",\n'
        f'    description="{config.get("description", "")}",\n'
        f'    owner="{config.get("owner", "")}",\n'
        f")\n"
    )


def generate_feature_service(service_name: str, view_name: str) -> str:
    return (
        f"{service_name} = FeatureService(\n"
        f'    name="{service_name}", features=[{view_name}]\n'
        f")\n"
    )


def generate_feature_description(types, feast_config: dict, file_name: str) -> str:
    """Assemble and write ``<file_path>/anovos.py``; returns its path."""
    parts = [
        _PREFIX,
        generate_file_source(feast_config["file_source"], file_name),
        generate_entity_definition(feast_config["entity"]),
        generate_feature_view(
            types,
            [
                feast_config["entity"]["id_col"],
                feast_config["file_source"]["timestamp_col"],
                feast_config["file_source"]["create_timestamp_col"],
            ],
            feast_config["feature_view"],
            feast_config["entity"]["name"],
        ),
    ]
    if "service_name" in feast_config:
        parts.append(
            generate_feature_service(feast_config["service_name"], feast_config["feature_view"]["name"])
        )
    content = "\n".join(parts)
    try:  # pragma: no cover - optional formatters
        from black import FileMode, format_str

        content = format_str(content, mode=FileMode())
        import isort

        content = isort.code(content)
    except ImportError:
        pass
    os.makedirs(feast_config["file_path"], exist_ok=True)
    feature_file = os.path.join(feast_config["file_path"], "anovos.py")
    with open(feature_file, "w") as f:
        f.write(content)
    return feature_file


def add_timestamp_columns(idf: Table, file_source_config: dict) -> Table:
    """The event and create timestamp columns, both the local time now to
    the second."""
    now = np.full(idf.nrows, np.datetime64(datetime.now()).astype("datetime64[s]"))
    col = host_to_column(now, idf.nrows, idf.device)
    odf = idf.with_column(file_source_config["timestamp_col"], col)
    return odf.with_column(file_source_config["create_timestamp_col"], col)
