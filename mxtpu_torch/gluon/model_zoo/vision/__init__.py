"""Gluon model zoo, vision models, of the PyTorch port
(``mxtpu/gluon/model_zoo/vision/__init__.py``). ``get_model(name)``
dispatches by name as ``mxtpu`` does; there are no pretrained weights
(load a local file with ``load_params``)."""
from .resnet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403
from .alexnet import *  # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403


def get_model(name, **kwargs):
    models = {
        "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
        "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
        "resnet152_v1": resnet152_v1,
        "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
        "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
        "resnet152_v2": resnet152_v2,
        "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
        "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
        "vgg19_bn": vgg19_bn,
        "alexnet": alexnet,
        "densenet121": densenet121, "densenet161": densenet161,
        "densenet169": densenet169, "densenet201": densenet201,
        "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
        "inceptionv3": inception_v3,
        "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
        "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    }
    name = name.lower()
    if name not in models:
        raise ValueError("Model %s is not supported. Available: %s"
                         % (name, sorted(models)))
    return models[name](**kwargs)
