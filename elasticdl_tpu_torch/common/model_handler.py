"""Strategy-dependent model handling: the port of
elasticdl_tpu/common/model_handler.py.

The handler keeps the JAX package's surface (`get_model_handler`,
`get_model_to_train`, `get_model_to_export`): training takes the model
as it is, and the export writes the artifact of api/exporter.py from
the latest valid checkpoint when one exists, else from the live state.
The mesh strategies' handler (`MeshModelHandler`) validates an SPMD
export, which waits for the port's SPMD path: it raises.
"""

import logging

logger = logging.getLogger(__name__)

#: the JAX package's mesh strategy names (`--distribution_strategy`);
#: ParameterServerStrategy is the mesh's alias there
MESH_STRATEGIES = ("AllreduceStrategy", "ParameterServerStrategy",
                   "MeshStrategy")


class ModelHandler(object):
    @classmethod
    def get_model_handler(cls, distribution_strategy=None,
                          checkpoint_dir=None):
        """A mesh strategy maps to MeshModelHandler, anything else
        ("Local", None) to LocalModelHandler."""
        if distribution_strategy in MESH_STRATEGIES:
            return MeshModelHandler(checkpoint_dir=checkpoint_dir)
        return LocalModelHandler(checkpoint_dir=checkpoint_dir)

    def __init__(self, checkpoint_dir=None):
        self._checkpoint_dir = checkpoint_dir

    def get_model_to_train(self, model):
        """Identity: the model trains as it is."""
        return model

    def get_model_to_export(self, model, state, export_dir,
                            host_manager=None):
        """Write the export artifact: from the latest valid checkpoint
        under the handler's checkpoint_dir when there is one, else from
        `state`; with `host_manager`, the host tables' rows of the same
        version ride along. Returns the export dir."""
        from elasticdl_tpu_torch.api import exporter
        from elasticdl_tpu_torch.checkpoint.saver import (
            get_latest_checkpoint_version,
        )

        if (self._checkpoint_dir and get_latest_checkpoint_version(
                self._checkpoint_dir) >= 0):
            logger.info("Exporting from checkpoint dir %s",
                        self._checkpoint_dir)
            return exporter.export_from_checkpoint(
                model, state, self._checkpoint_dir, export_dir,
                host_manager=host_manager)
        return exporter.export_model(model, state, export_dir,
                                     host_manager=host_manager)


class LocalModelHandler(ModelHandler):
    """The single-process strategy."""


class MeshModelHandler(ModelHandler):
    """The mesh strategies' handler: its export check (no sharded
    parameter or host table dropped) belongs to the SPMD path, which is
    not ported."""

    def __init__(self, checkpoint_dir=None):
        raise NotImplementedError(
            "MeshModelHandler: the mesh (SPMD) strategies are not ported "
            "(ROADMAP Queue 1 item 6)")
